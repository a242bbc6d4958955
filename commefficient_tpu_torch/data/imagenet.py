"""Federated ImageNet, one client per wnid class: the port's copy of
commefficient_tpu/data/imagenet.py (reference
data_utils/fed_imagenet.py, which refuses to download and wraps a
dataset already on disk).

Layouts under <dataset_dir>/ImageNet/, in order of preference:
  1. preprocessed/: one `client<i>.npy` per class ([n, H, W, 3] uint8,
     memory-mapped) and `val.npz` (images, labels);
  2. raw/train/<wnid>/*.JPEG (and raw/val/<wnid>/): decoded and resized
     on fetch with PIL, imported only there, one class file cached at a
     time;
  3. `synthetic_examples=(n_train, n_val)`: a 64-px smoke corpus of 16
     classes, the same generator and draw order as the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.utils.atomic_io import (
    atomic_save, atomic_savez,
)

NUM_CLASSES = 1000

# bump when _generate_synthetic's semantics change: the on-disk cache
# is keyed by geometry + this stamp (see _cached_stats_ok)
_SYNTH_VERSION = 1


class FedImageNet(FedDataset):
    num_classes = NUM_CLASSES

    def __init__(self, dataset_dir, dataset_name="ImageNet", transform=None,
                 do_iid=False, num_clients=None, train=True, download=False,
                 synthetic_examples: Optional[Tuple[int, int]] = None,
                 image_size: int = 224, seed: int = 0):
        self._synthetic_examples = synthetic_examples
        self._seed = seed
        self._size = image_size
        self._cache = {}
        self._wnid_files = None
        super().__init__(dataset_dir, dataset_name, transform, do_iid,
                         num_clients, train, download, seed)

    def _dir(self):
        return os.path.join(self.dataset_dir, self.dataset_name)

    def _pre(self, name):
        return os.path.join(self._dir(), "preprocessed", name)

    def _cached_stats_ok(self) -> bool:
        """Re-prepare when the cached synthetic corpus isn't the
        sizing asked for (see FedDataset._cached_stats_ok); real
        preprocessed/raw layouts on disk always win."""
        if self._synthetic_examples is None:
            return True
        raw = os.path.join(self._dir(), "raw", "train")
        # a preprocessed/ dir NOT written by _generate_synthetic is a
        # real layout; the synthetic one is identified by its stats
        # matching the deterministic generator geometry below
        if os.path.isdir(raw):
            return True
        try:
            with open(self.stats_path()) as f:
                stats = json.load(f)
        except (OSError, ValueError):
            # a missing, unreadable or torn stats file: re-prepare
            return False
        n_train, n_val = self._synthetic_examples
        n_cls = min(NUM_CLASSES, 16)
        per = max(n_train // n_cls, 1)
        ipc = stats["images_per_client"]
        return (stats.get("source", "synthetic") == "synthetic"
                and stats.get("synthetic_version",
                              _SYNTH_VERSION) == _SYNTH_VERSION
                and len(ipc) == n_cls and all(n == per for n in ipc)
                and stats["num_val_images"] == n_val)

    # ---- indexing -------------------------------------------------------
    def prepare(self, download: bool = False):
        if download:
            raise RuntimeError(
                "ImageNet cannot be downloaded automatically (reference "
                "fed_imagenet.py:15-16 takes the same stance)")
        pre = os.path.join(self._dir(), "preprocessed")
        raw = os.path.join(self._dir(), "raw", "train")
        if os.path.isdir(pre):
            counts = []
            for c in range(NUM_CLASSES):
                p = self._pre(f"client{c}.npy")
                if not os.path.exists(p):
                    break
                counts.append(len(np.load(p, mmap_mode="r")))
            n_val = len(np.load(self._pre("val.npz"))["labels"]) \
                if os.path.exists(self._pre("val.npz")) else 0
            self.write_stats(counts, n_val,
                             extra={"source": "preprocessed"})
        elif os.path.isdir(raw):
            wnids = sorted(os.listdir(raw))
            counts = [len(os.listdir(os.path.join(raw, w))) for w in wnids]
            val_dir = os.path.join(self._dir(), "raw", "val")
            n_val = (sum(len(os.listdir(os.path.join(val_dir, w)))
                         for w in os.listdir(val_dir))
                     if os.path.isdir(val_dir) else 0)
            self.write_stats(counts, n_val, extra={"source": "raw"})
        elif self._synthetic_examples is not None:
            n_train, n_val = self._synthetic_examples
            self._generate_synthetic(n_train, n_val)
        else:
            raise FileNotFoundError(
                f"No ImageNet under {self._dir()} (expected preprocessed/ "
                f"or raw/train/<wnid>/); pass synthetic_examples for a "
                f"smoke corpus")

    def _generate_synthetic(self, n_train: int, n_val: int):
        rng = np.random.RandomState(self._seed)
        hw = min(self._size, 64)  # keep the smoke corpus small
        n_cls = min(NUM_CLASSES, 16)
        per = max(n_train // n_cls, 1)
        os.makedirs(self._pre(""), exist_ok=True)
        counts = []
        templates = rng.rand(n_cls, hw, hw, 3).astype(np.float32)
        for c in range(n_cls):
            x = np.clip(templates[c] + rng.randn(per, hw, hw, 3) * 0.1,
                        0, 1)
            atomic_save(self._pre(f"client{c}.npy"),
                        (x * 255).astype(np.uint8))
            counts.append(per)
        yv = rng.randint(0, n_cls, n_val)
        xv = np.clip(templates[yv] + rng.randn(n_val, hw, hw, 3) * 0.1, 0, 1)
        atomic_savez(self._pre("val.npz"),
                     images=(xv * 255).astype(np.uint8), labels=yv)
        self.write_stats(counts, n_val,
                         extra={"source": "synthetic",
                                "synthetic_version": _SYNTH_VERSION})

    # ---- fetch ----------------------------------------------------------
    def _raw_class_images(self, cid: int) -> np.ndarray:
        from PIL import Image
        raw = os.path.join(self._dir(), "raw", "train")
        if self._wnid_files is None:
            wnids = sorted(os.listdir(raw))
            self._wnid_files = [
                (w, sorted(os.listdir(os.path.join(raw, w))))
                for w in wnids]
        wnid, files = self._wnid_files[cid]
        out = np.zeros((len(files), self._size, self._size, 3), np.uint8)
        for i, f in enumerate(files):
            img = Image.open(os.path.join(raw, wnid, f)).convert("RGB")
            out[i] = np.asarray(
                img.resize((self._size, self._size)), np.uint8)
        return out

    def _class_images(self, cid: int) -> np.ndarray:
        if cid not in self._cache:
            p = self._pre(f"client{cid}.npy")
            if os.path.exists(p):
                arr = np.load(p, mmap_mode="r")
            else:
                arr = self._raw_class_images(cid)
            # bounded cache: one class-file at a time (classes are
            # visited in sampler blocks, so locality is high)
            self._cache = {k: v for k, v in self._cache.items()
                           if k == "val"}
            self._cache[cid] = arr
        return self._cache[cid]

    def _get_train_batch(self, nat_client_id: int, idxs: np.ndarray):
        imgs = self._class_images(nat_client_id)[np.asarray(idxs)]
        labels = np.full(len(idxs), nat_client_id, np.int64)
        return np.asarray(imgs), labels

    def _get_val_batch(self, idxs: np.ndarray):
        if "val" not in self._cache:
            z = np.load(self._pre("val.npz"))
            self._cache["val"] = (z["images"], z["labels"])
        imgs, labels = self._cache["val"]
        return imgs[idxs], labels[idxs]
