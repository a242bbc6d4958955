"""Batched numpy augmentation, NHWC: the port's copy of
commefficient_tpu/data/transforms.py (reference
data_utils/transforms.py) for CIFAR, FEMNIST and ImageNet. The same
numpy draws in the same order, so the same seed augments identically
in both packages."""
from __future__ import annotations

import numpy as np

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2471, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4867, 0.4408], np.float32)
CIFAR100_STD = np.array([0.2675, 0.2565, 0.2761], np.float32)
FEMNIST_MEAN = np.array([0.9637], np.float32)
FEMNIST_STD = np.array([0.1597], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_float(images: np.ndarray) -> np.ndarray:
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    return images.astype(np.float32)


def normalize(images: np.ndarray, mean: np.ndarray,
              std: np.ndarray) -> np.ndarray:
    return (_to_float(images) - mean) / std


def random_crop_reflect(images: np.ndarray, pad: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Batched RandomCrop(size, padding=pad, reflect)."""
    n, h, w, _ = images.shape
    padded = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    ys = rng.randint(0, 2 * pad + 1, size=n)
    xs = rng.randint(0, 2 * pad + 1, size=n)
    yy = ys[:, None] + np.arange(h)[None, :]
    out = padded[np.arange(n)[:, None], yy]
    xx = xs[:, None] + np.arange(w)[None, :]
    return out[np.arange(n)[:, None, None],
               np.arange(h)[None, :, None], xx[:, None, :]]


def random_hflip(images: np.ndarray,
                 rng: np.random.RandomState) -> np.ndarray:
    flip = rng.rand(images.shape[0]) < 0.5
    out = images.copy()
    out[flip] = out[flip, :, ::-1]
    return out


def _make_cifar_transforms(mean, std, seed=0):
    rng = np.random.RandomState(seed)

    def train(images, labels):
        x = random_crop_reflect(images, 4, rng)
        x = random_hflip(x, rng)
        return normalize(x, mean, std), labels.astype(np.int32)

    def test(images, labels):
        return normalize(images, mean, std), labels.astype(np.int32)

    # the augmentation stream's generator, which FedLoader hands to the
    # sampler so resumes continue it (data/sampler.py)
    train.rng = rng
    return train, test


def cifar10_transforms(seed=0):
    return _make_cifar_transforms(CIFAR10_MEAN, CIFAR10_STD, seed)


def cifar100_transforms(seed=0):
    return _make_cifar_transforms(CIFAR100_MEAN, CIFAR100_STD, seed)



def femnist_transforms(seed=0):
    """Crop jitter on 28x28x1 digits: pad 2 with white (1.0) and take a
    random 28x28 window (the JAX package's approximation of the
    reference's rotation/rescale, transforms.py:47-54)."""
    rng = np.random.RandomState(seed)

    def train(images, labels):
        x = _to_float(images)
        n, h, w, _ = x.shape
        pad = 2
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    constant_values=1.0)
        ys = rng.randint(0, 2 * pad + 1, size=n)
        xs = rng.randint(0, 2 * pad + 1, size=n)
        yy = ys[:, None] + np.arange(h)[None, :]
        out = xp[np.arange(n)[:, None], yy]
        xx = xs[:, None] + np.arange(w)[None, :]
        out = out[np.arange(n)[:, None, None],
                  np.arange(h)[None, :, None], xx[:, None, :]]
        return (normalize(out, FEMNIST_MEAN, FEMNIST_STD),
                labels.astype(np.int32))

    def test(images, labels):
        return (normalize(images, FEMNIST_MEAN, FEMNIST_STD),
                labels.astype(np.int32))

    # the augmentation stream's generator, which FedLoader hands to the
    # sampler so resumes continue it (data/sampler.py)
    train.rng = rng
    return train, test


def imagenet_transforms(seed=0):
    """Random flip at train time on pre-resized images, then normalize
    (reference transforms.py:66-75)."""
    rng = np.random.RandomState(seed)

    def train(images, labels):
        x = random_hflip(images, rng)
        return (normalize(x, IMAGENET_MEAN, IMAGENET_STD),
                labels.astype(np.int32))

    def test(images, labels):
        return (normalize(images, IMAGENET_MEAN, IMAGENET_STD),
                labels.astype(np.int32))

    # the augmentation stream's generator, which FedLoader hands to the
    # sampler so resumes continue it (data/sampler.py)
    train.rng = rng
    return train, test

