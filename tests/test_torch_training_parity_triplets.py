"""The port's `tools/training_parity.py` on the CPU, in the two loss
patterns with a triplet term (`panoptic`: 0.9 CE + 0.1 triplet on the
logits; `embed`: CE ignoring 255 + 0.5 triplet on the embeddings), with
the same indices on both sides: the gates and step 0 as in
test_torch_training_parity.py.
"""

import pytest
import torch

from test_torch_training_parity import check_parity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_training_parity_holds_its_gates_with_triplets(capsys):
    check_parity(("panoptic", "embed"), capsys)
