"""The port's ring attention against JAX's on the CPU.

JAX's contract (tests/test_ring_attention.py:24-76): the ring equals the
dense attention, forward at 2e-5 and gradients of a sum of squares at
5e-4, with and without a key mask, and a fully-masked row gives no NaN.
Here the port's `ring_spatial_attention` runs on a ring of 4 gloo ranks
(spawned by `tests/torch_parallel_ranks.py`; a ring of 2 sends to and
receives from the same neighbour, so a permute that ran the wrong way
would pass there), each rank on its token shard, and the shards put
together are held at those tolerances to JAX's `ring_spatial_attention`
on a 4-device submesh of the 8 virtual CPU devices and to JAX's
`masked_attention_dense`, on the same weights (through the port's
converter) and inputs. Also: the permute's direction both ways, and a
ring of one (no process group) equal to the port's dense attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from maskunet_tpu.ops import attention as ja
from maskunet_tpu.parallel import ring_attention as jring
from maskunet_tpu_torch.ops import attention as ta
from maskunet_tpu_torch.parallel import ring_attention as tring
from maskunet_tpu_torch.utils import jax_weights

N_RING = 4
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:N_RING]), ("seq",))


def _setup(b=2, l=256, c=32, seed=0):
    """JAX's test inputs: (JAX params, tokens, key mask)."""
    kp, kx, km = jax.random.split(jax.random.key(seed), 3)
    params = ja.attention_init(kp, c)
    tokens = jax.random.normal(kx, (b, l, c), jnp.float32)
    mask = ja.random_key_mask(km, b, l)
    return params, tokens, mask


def _port_params(jp: dict) -> dict:
    """JAX attention params -> the port's names and layout, by the
    converter's own entries for an attention block."""
    return {k.split(".", 1)[1]: np.ascontiguousarray(
                fn(np.asarray(jax_weights._get(jp, path)))).astype(np.float32)
            for k, _, path, fn, _ in jax_weights._attention("a", ())}


def _cases():
    params, tokens, mask = _setup()
    nm_params, nm_tokens, _ = _setup(l=128)
    g_params, g_tokens, g_mask = _setup(b=1, l=128, c=16)
    fm_params, fm_tokens, _ = _setup(b=2, l=128)
    fm_mask = jnp.zeros((2, 128), bool).at[1].set(True)
    return {
        "mask": (params, tokens, mask, False),
        "no_mask": (nm_params, nm_tokens, None, False),
        "grads": (g_params, g_tokens, g_mask, True),
        "fully_masked": (fm_params, fm_tokens, fm_mask, False),
    }


@pytest.fixture(scope="module")
def ring():
    """One spawn of 4 ranks runs every case: the shards put together."""
    cases = _cases()
    got = ranks.spawn(ranks.ring_attention, N_RING, {
        name: {"params": _port_params(p), "tokens": np.asarray(t),
               "mask": None if m is None else np.asarray(m), "grads": g}
        for name, (p, t, m, g) in cases.items()})
    out = {}
    for name in cases:
        parts = [r[name] for r in got]
        out[name] = {"out": np.concatenate([p["out"] for p in parts], 1)}
        if "tokens" in parts[0]:
            out[name]["tokens"] = np.concatenate(
                [p["tokens"] for p in parts], 1)
            out[name]["params"] = [p["params"] for p in parts]
    out["permute"] = [r["permute"] for r in got]
    return cases, out


@pytest.mark.parametrize("name", ["mask", "no_mask"])
def test_ring_forward_matches_jax(ring, name):
    cases, got = ring
    params, tokens, mask, _ = cases[name]
    dense = ja.masked_attention_dense(params, tokens, mask)
    mesh = _mesh()
    jax_ring = jax.jit(lambda p, t: jring.ring_spatial_attention(
        p, t, mask, mesh=mesh))(params, tokens)
    np.testing.assert_allclose(got[name]["out"], np.asarray(jax_ring), **FWD)
    np.testing.assert_allclose(got[name]["out"], np.asarray(dense), **FWD)


def test_ring_gradients_match_jax(ring):
    """The sequence-parallel backward (autograd through the permutes):
    each shard's token gradient and the parameters' gradients summed over
    the ring, against JAX's ring gradients and the dense ones."""
    cases, got = ring
    params, tokens, mask, _ = cases["grads"]
    mesh = _mesh()

    def loss(fn):
        return lambda p, t: jnp.sum(jnp.square(fn(p, t)))

    dense = jax.grad(loss(lambda p, t: ja.masked_attention_dense(
        p, t, mask)), argnums=(0, 1))(params, tokens)
    jax_ring = jax.jit(jax.grad(loss(
        lambda p, t: jring.ring_spatial_attention(p, t, mask, mesh=mesh)),
        argnums=(0, 1)))(params, tokens)
    for want_p, want_t in (dense, jax_ring):
        np.testing.assert_allclose(got["grads"]["tokens"],
                                   np.asarray(want_t), **GRAD)
        want = _port_params(jax.tree.map(np.asarray, want_p))
        for rank_grads in got["grads"]["params"]:
            for k, v in want.items():
                np.testing.assert_allclose(rank_grads[k], v, err_msg=k,
                                           **GRAD)


def test_ring_safe_fully_masked(ring):
    cases, got = ring
    params, tokens, mask, _ = cases["fully_masked"]
    out = got["fully_masked"]["out"]
    assert not np.any(np.isnan(out))
    mesh = _mesh()
    want = jax.jit(lambda p, t: jring.ring_spatial_attention(
        p, t, mask, mesh=mesh))(params, tokens)
    np.testing.assert_allclose(out, np.asarray(want), **FWD)


def test_ring_permute_direction(ring):
    """Forward: rank r receives rank r - 1's tensor; backward: the
    gradient goes back, so rank r's input gets the weight rank r + 1
    applied to what it received."""
    _, got = ring
    for r, (received, grad) in enumerate(got["permute"]):
        assert received == (r - 1) % N_RING
        assert grad == (r + 1) % N_RING + 1


@pytest.mark.parametrize("with_mask", [True, False])
def test_ring_of_one_is_dense(with_mask):
    """Without a process group the ring has one rank: the port's dense
    attention, forward and gradients."""
    params, tokens, mask, _ = _cases()["grads"]
    m = torch.from_numpy(np.array(mask)) if with_mask else None
    outs = []
    for fn in (lambda p, t: tring.ring_spatial_attention(p, t, m, mesh=None),
               lambda p, t: ta.masked_attention_dense(p, t, m)):
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in _port_params(params).items()}
        t = torch.from_numpy(np.asarray(tokens)).requires_grad_(True)
        y = fn(p, t)
        outs.append([y.detach()] + list(torch.autograd.grad(
            y.square().sum(), [t, *p.values()])))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)
