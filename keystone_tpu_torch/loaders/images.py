"""Image ingestion: tars of JPEG or PNG files decoded on the host with PIL
(port of ``keystone_tpu/loaders/images.py``, numpy and PIL only).

Decode rules: an image with either side under 36 px, or one that does not
decode, is skipped; RGB and grayscale are kept, other modes converted to
RGB. Arrays are uint8 in [0, 255] by default, RGB, axes (x = row, y =
column, c) as the image nodes expect.

Size policy: ``size=None`` gives a Dataset of per-image arrays at their own
sizes; ``size=(X, Y)`` resizes every image bilinearly to one shape (RGB)
and gives one (n, X, Y, 3) batch, the form the batched featurizers take.

The VOC reader keys labels by the tar entry's full path (or its base
name); the ImageNet reader labels each image by its top directory through
a labels map file.
"""

from __future__ import annotations

import io
import logging
import os
import tarfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..data.dataset import Dataset

logger = logging.getLogger(__name__)

#: the smallest side an image may have
MIN_DIM = 36


def decode_image_bytes(
    data: bytes,
    min_dim: int = MIN_DIM,
    size: Optional[Tuple[int, int]] = None,
    dtype=np.uint8,
) -> Optional[np.ndarray]:
    """JPEG/PNG bytes → (x, y, c) array in [0, 255], or None when it does
    not decode or a side is under ``min_dim``. uint8 by default: pixels
    stay bytes until the device, where the image nodes cast them; pass
    ``dtype=np.float32`` for arithmetic on the host. ``size=(X, Y)``
    resizes bilinearly to RGB."""
    from PIL import Image as PILImage

    try:
        img = PILImage.open(io.BytesIO(data))
        img.load()
    except Exception as e:  # undecodable: logged and skipped
        logger.warning("failed to parse image: %s", e)
        return None
    if img.height < min_dim or img.width < min_dim:
        logger.warning("ignoring small image %dx%d", img.height, img.width)
        return None
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    if size is not None:
        # canonical-batch mode must yield uniform (X, Y, 3): real tars mix
        # grayscale and RGB JPEGs, and np.stack needs one channel count
        if img.mode != "RGB":
            img = img.convert("RGB")
        # PIL size is (width, height) = (y, x)
        img = img.resize((size[1], size[0]), PILImage.BILINEAR)
    arr = np.asarray(img, dtype=dtype)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def iter_tar_images(
    tar_path: str,
    name_prefix: Optional[str] = None,
    min_dim: int = MIN_DIM,
    size: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[str, np.ndarray]]:
    """(entry name, image array) of each image file in a tar, in tar order."""
    with tarfile.open(tar_path, "r:*") as tf:
        for entry in tf:
            if not entry.isfile():
                continue
            if name_prefix and not entry.name.startswith(name_prefix):
                continue
            fobj = tf.extractfile(entry)
            if fobj is None:
                continue
            arr = decode_image_bytes(fobj.read(), min_dim=min_dim, size=size)
            if arr is not None:
                yield entry.name, arr


def _tar_paths(data_path: str) -> List[str]:
    """A tar file, or every tar file in a directory, sorted."""
    if os.path.isdir(data_path):
        return sorted(
            os.path.join(data_path, f)
            for f in os.listdir(data_path)
            if os.path.isfile(os.path.join(data_path, f))
            and tarfile.is_tarfile(os.path.join(data_path, f))
        )
    return [data_path]


def _package(images: List[np.ndarray], size) -> Dataset:
    if size is not None and images:
        return Dataset.of(np.stack(images))
    return Dataset.from_items(images)


class LabeledImages:
    """Images + int labels (+ entry names). ``data`` is a Dataset of images
    (batched under a size policy, per-item list otherwise)."""

    def __init__(self, images: List[np.ndarray], labels, names: List[str], size):
        self.data = _package(images, size)
        self.labels = np.asarray(labels)
        self.names = names

    def __len__(self) -> int:
        return len(self.names)


def read_labels_map(labels_path: str) -> Dict[str, int]:
    """'<dirname> <int>' per line."""
    out: Dict[str, int] = {}
    with open(labels_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split()  # any whitespace, tolerant of runs/tabs
            if len(parts) < 2:
                raise ValueError(
                    f"{labels_path}:{lineno}: expected '<classdir> <int>', "
                    f"got {line!r}"
                )
            out[parts[0]] = int(parts[1])
    return out


def load_imagenet(
    data_path: str,
    labels_path: str,
    size: Optional[Tuple[int, int]] = None,
    min_dim: int = MIN_DIM,
) -> LabeledImages:
    """Tar(s) of images under class-named directories; an image's label is
    the map's value for its top directory."""
    labels_map = read_labels_map(labels_path)
    images, labels, names = [], [], []
    unmapped = set()
    for tar_path in _tar_paths(data_path):
        for name, arr in iter_tar_images(tar_path, min_dim=min_dim, size=size):
            class_dir = name.lstrip("./").split("/")[0]
            if class_dir not in labels_map:
                unmapped.add(class_dir)
                continue
            images.append(arr)
            labels.append(labels_map[class_dir])
            names.append(name)
    if unmapped:
        logger.warning("skipped entries from unmapped class dirs: %s",
                       sorted(unmapped))
    return LabeledImages(images, np.asarray(labels, dtype=np.int32), names, size)


def read_voc_labels(labels_path: str) -> Dict[str, List[int]]:
    """VOC label CSV: a header row, then one row per object, column 4 the
    (quoted) file name and column 1 its 1-indexed class; a file with
    several objects gets several labels."""
    import csv

    out: Dict[str, List[int]] = {}
    with open(labels_path, newline="") as f:
        reader = csv.reader(f)  # honors quoted fields containing commas
        rows = list(reader)
    for lineno, parts in enumerate(rows[1:], 2):
        if not parts or not any(p.strip() for p in parts):
            continue
        if len(parts) < 5:
            raise ValueError(
                f"{labels_path}:{lineno}: expected >=5 CSV columns "
                f"(VOCLoader format), got {len(parts)}"
            )
        fname = parts[4]
        label = int(parts[1]) - 1
        out.setdefault(fname, []).append(label)
    return out


class MultiLabeledImages:
    """Images + per-image label lists (VOC: multiple objects per image)."""

    def __init__(self, images: List[np.ndarray], labels: List[List[int]],
                 names: List[str], size):
        self.data = _package(images, size)
        self.labels = labels
        self.names = names

    def label_matrix(self, num_classes: int) -> np.ndarray:
        """±1 multi-label indicator matrix (n, num_classes), from the
        MultiClassLabelIndicators node."""
        from ..nodes.util import MultiClassLabelIndicators

        ds = MultiClassLabelIndicators(num_classes).apply_batch(
            Dataset.from_items(list(self.labels))
        )
        return ds.to_array().numpy()

    def __len__(self) -> int:
        return len(self.names)


def load_voc(
    data_path: str,
    labels_path: str,
    name_prefix: Optional[str] = None,
    size: Optional[Tuple[int, int]] = None,
    min_dim: int = MIN_DIM,
) -> MultiLabeledImages:
    """VOC tar(s) and label CSV → multi-labeled images."""
    labels_map = read_voc_labels(labels_path)
    images, labels, names = [], [], []
    for tar_path in _tar_paths(data_path):
        for name, arr in iter_tar_images(
            tar_path, name_prefix=name_prefix, min_dim=min_dim, size=size
        ):
            # the CSV keys are full tar-entry paths; a base name matches
            # too, for hand-built files
            key = name if name in labels_map else os.path.basename(name)
            if key not in labels_map:
                continue
            images.append(arr)
            labels.append(labels_map[key])
            names.append(name)
    return MultiLabeledImages(images, labels, names, size)
