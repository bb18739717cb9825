"""The port's dataset acquisition against a loopback HTTP mock (no
network), as tests/test_download.py tests the JAX package's.

Covers `maskunet_tpu_torch/data/download.py` (a copy of
`maskunet_tpu/data/download.py`), the script transcription of the
reference's three download notebooks (data/COCO/coco_download.ipynb subset
cell, data/ADEK/ade_download.ipynb, data/Cityscapes/
cityscapes_download.ipynb): a local http.server serves tiny generated
zips with the real archives' internal layout, and the tests assert the
extracted directory structure, the seeded 10k-subset sampling, and the
`panoptic_train_subset.json` contents.
"""

import http.server
import io
import json
import os
import random
import threading
import zipfile

import pytest

from maskunet_tpu_torch.data import download


# ---------------------------------------------------------------------------
# Tiny archive builders (mirror the real archives' internal layout)
# ---------------------------------------------------------------------------

N_IMAGES = 12


def _zip_bytes(entries: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in entries.items():
            z.writestr(name, data)
    return buf.getvalue()


def _coco_panoptic_json(split: str, n: int) -> bytes:
    images = [{"id": i, "file_name": f"{i:012d}.jpg",
               "width": 4, "height": 4} for i in range(n)]
    anns = [{"image_id": i, "file_name": f"{i:012d}.png",
             "segments_info": [{"id": 1, "category_id": 1,
                                "area": 16, "iscrowd": 0,
                                "bbox": [0, 0, 4, 4]}]}
            for i in range(n)]
    cats = [{"id": 1, "name": "thing", "isthing": 1},
            {"id": 2, "name": "stuff", "isthing": 0}]
    return json.dumps({"images": images, "annotations": anns,
                       "categories": cats}).encode()


def _make_coco_archives() -> dict[str, bytes]:
    train_imgs = {f"train2017/{i:012d}.jpg": b"jpg%d" % i
                  for i in range(N_IMAGES)}
    val_imgs = {f"val2017/{i:012d}.jpg": b"jpg%d" % i for i in range(3)}
    # the real panoptic annotations zip nests per-split PNG zips inside
    # annotations/ next to the jsons; download_coco extracts those inner
    # zips to the root afterwards
    pan_train_pngs = _zip_bytes({f"panoptic_train2017/{i:012d}.png":
                                 b"png%d" % i for i in range(N_IMAGES)})
    pan_val_pngs = _zip_bytes({f"panoptic_val2017/{i:012d}.png":
                               b"png%d" % i for i in range(3)})
    return {
        "train2017.zip": _zip_bytes(train_imgs),
        "val2017.zip": _zip_bytes(val_imgs),
        "annotations_trainval2017.zip": _zip_bytes({
            "annotations/instances_train2017.json": b"{}",
            "annotations/instances_val2017.json": b"{}",
        }),
        "panoptic_annotations_trainval2017.zip": _zip_bytes({
            "annotations/panoptic_train2017.json":
                _coco_panoptic_json("train2017", N_IMAGES),
            "annotations/panoptic_val2017.json":
                _coco_panoptic_json("val2017", 3),
            "annotations/panoptic_train2017.zip": pan_train_pngs,
            "annotations/panoptic_val2017.zip": pan_val_pngs,
        }),
    }


def _make_ade_archive() -> bytes:
    pre = "ADEChallengeData2016"
    return _zip_bytes({
        f"{pre}/images/training/ADE_train_00000001.jpg": b"jpg",
        f"{pre}/images/validation/ADE_val_00000001.jpg": b"jpg",
        f"{pre}/annotations/training/ADE_train_00000001.png": b"png",
        f"{pre}/annotations/validation/ADE_val_00000001.png": b"png",
        f"{pre}/objectInfo150.txt": b"Idx\tRatio\tTrain\tVal\tName\n"
                                    b"1\t0.1\t1\t1\twall\n",
        f"{pre}/sceneCategories.txt": b"ADE_train_00000001 airport\n",
    })


# ---------------------------------------------------------------------------
# Loopback server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mock_server():
    files = dict(_make_coco_archives())
    files["ADEChallengeData2016.zip"] = _make_ade_archive()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API)
            name = self.path.rsplit("/", 1)[-1]
            data = files.get(name)
            if data is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # keep pytest output clean
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join(timeout=5)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_download_coco_layout_and_subset(mock_server, tmp_path,
                                         monkeypatch):
    """Full coco_download.ipynb flow against the mock: zips fetched,
    extracted (incl. the nested panoptic PNG zips), and the seeded subset
    materialized as train_subset/ + panoptic_train_subset/ +
    annotations/panoptic_train_subset.json."""
    monkeypatch.setattr(download, "COCO_URLS", {
        name: f"{mock_server}/{name}" for name in download.COCO_URLS})
    root = str(tmp_path / "coco")
    num_subset = 5
    download.download_coco(root, num_subset=num_subset)

    # extracted layout
    assert len(os.listdir(os.path.join(root, "train2017"))) == N_IMAGES
    assert len(os.listdir(os.path.join(root, "val2017"))) == 3
    assert os.path.exists(
        os.path.join(root, "annotations", "instances_train2017.json"))
    assert len(os.listdir(
        os.path.join(root, "panoptic_train2017"))) == N_IMAGES
    assert len(os.listdir(os.path.join(root, "panoptic_val2017"))) == 3

    # subset: right sizes, image<->annotation correspondence, bytes copied
    with open(os.path.join(root, "annotations",
                           "panoptic_train_subset.json")) as f:
        sub = json.load(f)
    assert len(sub["images"]) == num_subset
    assert len(sub["annotations"]) == num_subset
    assert {i["id"] for i in sub["images"]} == \
        {a["image_id"] for a in sub["annotations"]}
    # categories preserved verbatim (the notebook keeps the full list)
    assert sub["categories"] == json.loads(
        _coco_panoptic_json("", 1))["categories"]
    img_files = sorted(os.listdir(os.path.join(root, "train_subset")))
    assert img_files == sorted(i["file_name"] for i in sub["images"])
    png_files = sorted(os.listdir(
        os.path.join(root, "panoptic_train_subset")))
    assert png_files == sorted(a["file_name"] for a in sub["annotations"])
    one = sub["images"][0]
    with open(os.path.join(root, "train_subset", one["file_name"]),
              "rb") as f:
        assert f.read() == b"jpg%d" % one["id"]

    # seeded sampling is deterministic and matches the notebook's
    # random.Random(seed).sample over the json's image list
    expected = random.Random(42).sample(
        [{"id": i, "file_name": f"{i:012d}.jpg", "width": 4, "height": 4}
         for i in range(N_IMAGES)], num_subset)
    assert sub["images"] == expected

    # idempotent re-run (zips cached, subset rebuilt identically)
    download.build_coco_subset(root, num_subset=num_subset)
    with open(os.path.join(root, "annotations",
                           "panoptic_train_subset.json")) as f:
        assert json.load(f) == sub


def test_coco_subset_larger_than_dataset(tmp_path):
    """num_subset > available images degrades to 'all of them' (the
    notebook's min() clamp) instead of raising."""
    root = str(tmp_path)
    ann = os.path.join(root, "annotations")
    os.makedirs(ann)
    os.makedirs(os.path.join(root, "train2017"))
    os.makedirs(os.path.join(root, "panoptic_train2017"))
    with open(os.path.join(ann, "panoptic_train2017.json"), "wb") as f:
        f.write(_coco_panoptic_json("train2017", 3))
    for i in range(3):
        for d, ext in (("train2017", "jpg"), ("panoptic_train2017", "png")):
            with open(os.path.join(root, d, f"{i:012d}.{ext}"), "wb") as f:
                f.write(b"x")
    download.build_coco_subset(root, num_subset=10000)
    with open(os.path.join(ann, "panoptic_train_subset.json")) as f:
        sub = json.load(f)
    assert len(sub["images"]) == 3
    assert len(os.listdir(os.path.join(root, "train_subset"))) == 3


def test_download_ade20k_layout(mock_server, tmp_path, monkeypatch):
    """ade_download.ipynb flow: zip extracted and images/, annotations/,
    objectInfo150.txt moved up to the dataset root."""
    monkeypatch.setattr(download, "ADE_URL",
                        f"{mock_server}/ADEChallengeData2016.zip")
    root = str(tmp_path / "ade")
    download.download_ade20k(root)
    for sub in ("images/training", "images/validation",
                "annotations/training", "annotations/validation"):
        assert os.listdir(os.path.join(root, sub))
    with open(os.path.join(root, "objectInfo150.txt")) as f:
        assert "wall" in f.read()
    # re-run with zips cached: no crash, layout unchanged
    download.download_ade20k(root)
    assert os.path.exists(os.path.join(root, "objectInfo150.txt"))


def test_sources_equal_jax():
    """The same archives from the same places as the JAX package's."""
    from maskunet_tpu.data import download as jdownload
    assert download.COCO_URLS == jdownload.COCO_URLS
    assert download.ADE_URL == jdownload.ADE_URL
