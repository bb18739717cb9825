"""Dataset acquisition: script equivalents of the reference's notebooks.

Counterpart of maskunet_tpu/data/download.py (the same URLs, layouts and
subset logic; stdlib only). The reference ships three Jupyter notebooks
that download and arrange the raw data; these functions reproduce them as
importable, scriptable code:

- `download_coco(root, num_subset=10000)`: train/val2017 image zips +
  instance & panoptic annotation zips, extracted, then a seeded
  `num_subset`-image random subset is materialized as `train_subset/`,
  `panoptic_train_subset/`, and `annotations/panoptic_train_subset.json`
  (data/COCO/coco_download.ipynb, subset cell `num_samples = 10000`).
- `download_ade20k(root)`: ADEChallengeData2016.zip, with `images/` and
  `annotations/` moved to the root (data/ADEK/ade_download.ipynb).
- `download_cityscapes(root, username, password)`: cookie-login download of
  gtFine + leftImg8bit (data/Cityscapes/cityscapes_download.ipynb) —
  requires cityscapes-dataset.com credentials.

All need the network; without one, point the readers at pre-arranged
directories with the same layout instead.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import urllib.request
import zipfile

COCO_URLS = {
    "train2017.zip": "http://images.cocodataset.org/zips/train2017.zip",
    "val2017.zip": "http://images.cocodataset.org/zips/val2017.zip",
    "annotations_trainval2017.zip":
        "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
    "panoptic_annotations_trainval2017.zip":
        "http://images.cocodataset.org/annotations/panoptic_annotations_trainval2017.zip",
}
ADE_URL = ("http://data.csail.mit.edu/places/ADEchallenge/"
           "ADEChallengeData2016.zip")


def _fetch(url: str, dest: str) -> None:
    if os.path.exists(dest):
        return
    print(f"downloading {url} -> {dest}")
    urllib.request.urlretrieve(url, dest + ".part")
    os.replace(dest + ".part", dest)


def _extract(zip_path: str, dest: str) -> None:
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(dest)


def build_coco_subset(root: str, num_subset: int = 10000,
                      seed: int = 42) -> None:
    """Materialize the 10k panoptic training subset the reference trains
    on: subset images + panoptic PNGs + filtered json."""
    ann_dir = os.path.join(root, "annotations")
    with open(os.path.join(ann_dir, "panoptic_train2017.json")) as f:
        pan = json.load(f)
    rng = random.Random(seed)
    images = rng.sample(pan["images"], min(num_subset, len(pan["images"])))
    keep_ids = {img["id"] for img in images}
    anns = [a for a in pan["annotations"] if a["image_id"] in keep_ids]

    img_out = os.path.join(root, "train_subset")
    pan_out = os.path.join(root, "panoptic_train_subset")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(pan_out, exist_ok=True)
    for img in images:
        shutil.copy(os.path.join(root, "train2017", img["file_name"]),
                    os.path.join(img_out, img["file_name"]))
    for ann in anns:
        shutil.copy(os.path.join(root, "panoptic_train2017",
                                 ann["file_name"]),
                    os.path.join(pan_out, ann["file_name"]))
    with open(os.path.join(ann_dir, "panoptic_train_subset.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": pan["categories"]}, f)


def download_coco(root: str, num_subset: int = 10000) -> None:
    os.makedirs(root, exist_ok=True)
    for name, url in COCO_URLS.items():
        path = os.path.join(root, name)
        _fetch(url, path)
        _extract(path, root)
    # panoptic PNG zips live inside the annotations zip
    for split in ("train2017", "val2017"):
        inner = os.path.join(root, "annotations", f"panoptic_{split}.zip")
        if os.path.exists(inner):
            _extract(inner, root)
    build_coco_subset(root, num_subset)


def download_ade20k(root: str) -> None:
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "ADEChallengeData2016.zip")
    _fetch(ADE_URL, path)
    _extract(path, root)
    inner = os.path.join(root, "ADEChallengeData2016")
    for sub in ("images", "annotations", "objectInfo150.txt",
                "sceneCategories.txt"):
        src = os.path.join(inner, sub)
        dst = os.path.join(root, sub)
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.move(src, dst)


def download_cityscapes(root: str, username: str, password: str) -> None:
    """Cookie-login download (the notebook's wget flow). Credentials from
    cityscapes-dataset.com registration."""
    import http.cookiejar
    import urllib.parse

    os.makedirs(root, exist_ok=True)
    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))
    login = urllib.parse.urlencode({
        "username": username, "password": password, "submit": "Login",
    }).encode()
    opener.open("https://www.cityscapes-dataset.com/login/", login)
    for pkg_id, name in ((1, "gtFine_trainvaltest.zip"),
                         (3, "leftImg8bit_trainvaltest.zip")):
        dest = os.path.join(root, name)
        if os.path.exists(dest):
            continue
        url = ("https://www.cityscapes-dataset.com/file-handling/"
               f"?packageID={pkg_id}")
        print(f"downloading {name}")
        with opener.open(url) as r, open(dest, "wb") as f:
            shutil.copyfileobj(r, f)
        _extract(dest, root)
