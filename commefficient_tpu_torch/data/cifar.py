"""Federated CIFAR10/CIFAR100: the port's copy of
commefficient_tpu/data/cifar.py (reference data_utils/fed_cifar.py).

The train set is partitioned one natural unit per class (label ==
natural client id) and resharded over num_clients; the val set is
flat. Sources, in order: the standard CIFAR python pickles under
dataset_dir, else the deterministic synthetic corpus of
`_synthetic_cifar` (the same generator and draw order as the JAX
package, so both packages see identical images). Storage: one .npy per
class under <dataset_dir>/<name>/, the same layout and stats stamp as
the JAX package's cache.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.utils.atomic_io import atomic_save, atomic_savez


def _try_load_cifar_pickles(root: str, name: str):
    if name == "CIFAR10":
        d = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(d):
            return None
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xs.append(b[b"data"])
            ys.extend(b[b"labels"])
        with open(os.path.join(d, "test_batch"), "rb") as f:
            tb = pickle.load(f, encoding="bytes")
        train = (np.concatenate(xs), np.array(ys))
        test = (np.asarray(tb[b"data"]), np.array(tb[b"labels"]))
    else:
        d = os.path.join(root, "cifar-100-python")
        if not os.path.isdir(d):
            return None
        with open(os.path.join(d, "train"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        train = (np.asarray(b[b"data"]), np.array(b[b"fine_labels"]))
        with open(os.path.join(d, "test"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        test = (np.asarray(b[b"data"]), np.array(b[b"fine_labels"]))

    def to_nhwc(x):
        return x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    return (to_nhwc(train[0]), train[1]), (to_nhwc(test[0]), test[1])


# the JAX package's generator version: a cache stamped with another
# version is re-prepared
_SYNTH_VERSION = 2


def _synthetic_cifar(num_classes: int, n_train: int, n_val: int, seed: int,
                     signal: float = 0.6):
    """Deterministic class-separable images: low-frequency (8x8 blocks
    upsampled to 32x32), horizontally symmetric class protos mixed with
    uniform noise, so the standard crop/flip augmentation keeps the
    class signal. `signal` is the proto weight (1 - signal is noise)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(num_classes, 8, 8, 3).astype(np.float32)
    base = (base + base[:, :, ::-1]) / 2            # flip-invariant
    protos = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)

    def gen(n):
        labels = rng.randint(0, num_classes, size=n)
        noise = rng.rand(n, 32, 32, 3).astype(np.float32)
        imgs = signal * protos[labels] + (1.0 - signal) * noise
        return (imgs * 255).astype(np.uint8), labels.astype(np.int64)

    return gen(n_train), gen(n_val)


class FedCIFAR10(FedDataset):
    num_classes = 10

    def __init__(self, dataset_dir, dataset_name="CIFAR10", transform=None,
                 do_iid=False, num_clients=None, train=True, download=False,
                 synthetic_examples: Optional[Tuple[int, int]] = None,
                 seed: int = 0, synthetic_signal: float = 0.6):
        self._synthetic_examples = synthetic_examples
        self._synthetic_signal = synthetic_signal
        self._seed = seed
        super().__init__(dataset_dir, dataset_name, transform, do_iid,
                         num_clients, train, download, seed)
        self._cache = {}

    def _dir(self):
        return os.path.join(self.dataset_dir, self.dataset_name)

    def _cached_stats_ok(self) -> bool:
        """Re-prepare unless the cache is the corpus that would be
        prepared now: real pickles win over a synthetic cache, and a
        synthetic cache must match the requested sizing, signal and
        generator version."""
        try:
            with open(self.stats_path()) as f:
                stats = json.load(f)
        except (OSError, ValueError):
            return False
        have_pickles = _try_load_cifar_pickles(
            self.dataset_dir, self.dataset_name) is not None
        if have_pickles:
            return stats.get("source") == "pickles"
        if self._synthetic_examples is None:
            return True
        n_train, n_val = self._synthetic_examples
        return (stats.get("source") == "synthetic"
                and sum(stats["images_per_client"]) == n_train
                and stats["num_val_images"] == n_val
                and stats.get("synthetic_version") == _SYNTH_VERSION
                and stats.get("synthetic_signal") == self._synthetic_signal)

    def prepare(self, download: bool = False):
        loaded = _try_load_cifar_pickles(self.dataset_dir,
                                         self.dataset_name)
        if loaded is None:
            if self._synthetic_examples is None:
                raise FileNotFoundError(
                    f"No {self.dataset_name} archives under "
                    f"{self.dataset_dir}; pass synthetic_examples="
                    f"(n_train, n_val) to generate synthetic data")
            n_train, n_val = self._synthetic_examples
            (xtr, ytr), (xva, yva) = _synthetic_cifar(
                self.num_classes, n_train, n_val, self._seed,
                signal=self._synthetic_signal)
        else:
            (xtr, ytr), (xva, yva) = loaded

        os.makedirs(self._dir(), exist_ok=True)
        images_per_client = []
        for c in range(self.num_classes):
            sel = ytr == c
            atomic_save(os.path.join(self._dir(), f"client{c}.npy"),
                        xtr[sel])
            images_per_client.append(int(sel.sum()))
        atomic_savez(os.path.join(self._dir(), "val.npz"),
                     images=xva, labels=yva)
        self.write_stats(
            images_per_client, len(yva),
            extra=({"source": "pickles"} if loaded is not None else
                   {"source": "synthetic",
                    "synthetic_version": _SYNTH_VERSION,
                    "synthetic_signal": self._synthetic_signal}))

    def _client_images(self, cid: int) -> np.ndarray:
        if cid not in self._cache:
            self._cache[cid] = np.load(
                os.path.join(self._dir(), f"client{cid}.npy"))
        return self._cache[cid]

    def _get_train_batch(self, nat_client_id: int, idxs: np.ndarray):
        imgs = self._client_images(nat_client_id)[idxs]
        labels = np.full(len(idxs), nat_client_id, np.int64)
        return imgs, labels

    def _get_val_batch(self, idxs: np.ndarray):
        if "val" not in self._cache:
            z = np.load(os.path.join(self._dir(), "val.npz"))
            self._cache["val"] = (z["images"], z["labels"])
        imgs, labels = self._cache["val"]
        return imgs[idxs], labels[idxs]


class FedCIFAR100(FedCIFAR10):
    num_classes = 100

    def __init__(self, dataset_dir, dataset_name="CIFAR100", **kw):
        super().__init__(dataset_dir, dataset_name, **kw)
