"""The port's EMNIST and ImageNet data layers (data/emnist.py,
data/imagenet.py, data/transforms.py) against the JAX package's, case
for case with tests/test_emnist_imagenet.py: the same files on disk give
byte-identical batches and labels in both packages, with each train
transform applied from the same seed; and the port's cv_train --test
smokes on both datasets."""
import os
import shutil

import numpy as np
import pytest

from commefficient_tpu.data import FedLoader as JFedLoader
from commefficient_tpu.data import transforms as jtransforms
from commefficient_tpu.data.emnist import (
    FedEMNIST as JFedEMNIST, _synthetic_emnist as j_synthetic_emnist,
    read_leaf_dir as j_read_leaf_dir,
)
from commefficient_tpu.data.imagenet import FedImageNet as JFedImageNet
from commefficient_tpu_torch.data import FedLoader, transforms
from commefficient_tpu_torch.data.emnist import (
    FedEMNIST, _synthetic_emnist, read_leaf_dir,
)
from commefficient_tpu_torch.data.imagenet import FedImageNet
from commefficient_tpu_torch.training import cv_train

pytestmark = pytest.mark.torch_port


def _same(a, b):
    """Equal arrays: the same dtype, shape and bytes."""
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _pair(jcls, tcls, root, name, tseed=0, **kw):
    """The JAX and the port's dataset over copies of one corpus at
    root/<name> (each package writes its own stats.json), with their
    train transforms from `tseed`."""
    factory = {"EMNIST": "femnist_transforms",
               "ImageNet": "imagenet_transforms"}[name]
    for side in ("j", "t"):
        if os.path.isdir(os.path.join(root, name)):
            shutil.copytree(os.path.join(root, name),
                            os.path.join(root, side, name))
    jset = jcls(os.path.join(root, "j"),
                transform=getattr(jtransforms, factory)(tseed)[0], **kw)
    tset = tcls(os.path.join(root, "t"),
                transform=getattr(transforms, factory)(tseed)[0], **kw)
    return jset, tset


def _check_batches(jset, tset, client_idxs, val_idxs):
    np.testing.assert_array_equal(tset.images_per_client,
                                  jset.images_per_client)
    assert tset.num_val_images == jset.num_val_images
    # twice per client: the augmentation streams stay in step
    for cid, idxs in client_idxs * 2:
        _same(jset.get_client_batch(cid, np.asarray(idxs)),
              tset.get_client_batch(cid, np.asarray(idxs)))
    if val_idxs is not None:
        _same(jset.get_val_batch(np.asarray(val_idxs)),
              tset.get_val_batch(np.asarray(val_idxs)))


# ---- LEAF parser ---------------------------------------------------------

def _write_leaf_fixture(raw_dir, users):
    import json
    os.makedirs(raw_dir, exist_ok=True)
    shard = {"users": list(users),
             "num_samples": [len(users[u][1]) for u in users],
             "user_data": {
                 u: {"x": [img.reshape(-1).tolist() for img in x],
                     "y": list(map(int, y))}
                 for u, (x, y) in users.items()}}
    with open(os.path.join(raw_dir, "all_data_0.json"), "w") as f:
        json.dump(shard, f)


def _leaf_users(n_users=3, per_user=5, seed=0):
    rng = np.random.RandomState(seed)
    return {f"f{u:04d}": (rng.rand(per_user, 28, 28).astype(np.float32),
                          rng.randint(0, 62, per_user))
            for u in range(n_users)}


def test_read_leaf_dir(tmp_path):
    _write_leaf_fixture(str(tmp_path / "raw"), _leaf_users())
    want = j_read_leaf_dir(str(tmp_path / "raw"))
    got = read_leaf_dir(str(tmp_path / "raw"))
    assert sorted(got) == sorted(want)
    for u in want:
        _same(want[u], got[u])
        assert got[u][0].shape == (5, 28, 28, 1)


def test_emnist_from_leaf_shards(tmp_path):
    _write_leaf_fixture(str(tmp_path / "EMNIST" / "raw" / "train"),
                        _leaf_users(n_users=4, per_user=6))
    _write_leaf_fixture(str(tmp_path / "EMNIST" / "raw" / "test"),
                        _leaf_users(n_users=2, per_user=3, seed=1))
    jset, tset = _pair(JFedEMNIST, FedEMNIST, str(tmp_path), "EMNIST",
                       tseed=3, train=True)
    assert tset.num_clients == jset.num_clients == 4
    assert tset.num_val_images == 6
    _check_batches(jset, tset, [(2, [0, 3]), (0, [5, 1, 2])], [0, 5])
    x, y = tset.get_client_batch(1, np.arange(6))
    assert x.shape == (6, 28, 28, 1) and x.dtype == np.float32
    assert y.dtype == np.int32


def test_emnist_synthetic(tmp_path):
    for a, b in zip(j_synthetic_emnist(8, 12, 64, 3),
                    _synthetic_emnist(8, 12, 64, 3)):
        if isinstance(a, list):
            for wa, wb in zip(a, b):
                _same(wa, wb)
        else:
            _same(a, b)
    jset, tset = _pair(JFedEMNIST, FedEMNIST, str(tmp_path), "EMNIST",
                       tseed=3, train=True, synthetic_examples=(8, 12),
                       seed=3)
    assert tset.num_clients == 8
    _check_batches(jset, tset, [(0, np.arange(4)), (7, [11, 0])],
                   np.arange(10))


# ---- ImageNet layouts ----------------------------------------------------

def test_imagenet_preprocessed_layout(tmp_path):
    pre = tmp_path / "ImageNet" / "preprocessed"
    pre.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for c in range(3):
        np.save(str(pre / f"client{c}.npy"),
                rng.randint(0, 255, (4 + c, 8, 8, 3), dtype=np.uint8))
    np.savez(str(pre / "val.npz"),
             images=rng.randint(0, 255, (5, 8, 8, 3), dtype=np.uint8),
             labels=rng.randint(0, 3, 5))
    jset, tset = _pair(JFedImageNet, FedImageNet, str(tmp_path),
                       "ImageNet", tseed=4, train=True)
    np.testing.assert_array_equal(tset.images_per_client, [4, 5, 6])
    _check_batches(jset, tset, [(1, [0, 2]), (2, [5, 4, 0, 1])], [0, 4])
    _, y = tset.get_client_batch(1, np.array([0, 2]))
    np.testing.assert_array_equal(y, [1, 1])  # label == wnid client


def test_imagenet_iid_loader_rounds_match_jax(tmp_path):
    # config #4's partition: classes reshuffled IID over num_clients,
    # rounds drawn by the sampler, every client's batch flipped and
    # normalized: identical rounds in both packages
    pre = tmp_path / "ImageNet" / "preprocessed"
    pre.mkdir(parents=True)
    rng = np.random.RandomState(1)
    for c in range(6):
        np.save(str(pre / f"client{c}.npy"),
                rng.randint(0, 255, (10, 12, 12, 3), dtype=np.uint8))
    np.savez(str(pre / "val.npz"),
             images=rng.randint(0, 255, (4, 12, 12, 3), dtype=np.uint8),
             labels=rng.randint(0, 6, 4))
    jset, tset = _pair(JFedImageNet, FedImageNet, str(tmp_path),
                       "ImageNet", tseed=5, train=True, do_iid=True,
                       num_clients=7, seed=5)
    np.testing.assert_array_equal(tset.data_per_client, jset.data_per_client)
    jl = JFedLoader(jset, 3, 4, seed=5, max_local_batch=4)
    tl = FedLoader(tset, 3, 4, seed=5, max_local_batch=4)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    jrounds, trounds = list(jl.epoch()), list(tl.epoch())
    assert len(trounds) == len(jrounds) > 0
    for (jid, jd, jm), (tid, td, tm) in zip(jrounds, trounds):
        np.testing.assert_array_equal(tid, jid)
        np.testing.assert_array_equal(tm, jm)
        _same(jd, td)


def test_imagenet_raw_jpeg_layout(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    raw = tmp_path / "ImageNet" / "raw" / "train"
    rng = np.random.RandomState(0)
    for wnid in ["n01440764", "n01443537"]:
        d = raw / wnid
        d.mkdir(parents=True)
        for i in range(3):
            img = Image.fromarray(
                rng.randint(0, 255, (16, 20, 3), dtype=np.uint8))
            img.save(str(d / f"{wnid}_{i}.JPEG"))
    jset, tset = _pair(JFedImageNet, FedImageNet, str(tmp_path),
                       "ImageNet", tseed=6, train=True, image_size=8)
    np.testing.assert_array_equal(tset.images_per_client, [3, 3])
    _check_batches(jset, tset, [(0, [0, 1]), (1, [2, 0])], None)
    x, y = tset.get_client_batch(0, np.array([0, 1]))
    assert x.shape == (2, 8, 8, 3)  # decoded + resized
    np.testing.assert_array_equal(y, [0, 0])


def test_imagenet_synthetic(tmp_path):
    jset, tset = _pair(JFedImageNet, FedImageNet, str(tmp_path),
                       "ImageNet", tseed=1, train=True, seed=1,
                       synthetic_examples=(64, 16))
    assert tset.num_clients == 16
    _check_batches(jset, tset, [(5, np.arange(2)), (15, [3, 1])],
                   np.arange(16))
    x, _ = tset.get_client_batch(5, np.arange(2))
    assert x.shape == (2, 64, 64, 3)


def test_imagenet_refuses_download(tmp_path):
    with pytest.raises(RuntimeError, match="cannot be downloaded"):
        FedImageNet(str(tmp_path / "none"), train=True, download=True)
    with pytest.raises(FileNotFoundError):
        FedImageNet(str(tmp_path / "none"), train=True)


# ---- driver wiring (the JAX test's flags, tests/test_emnist_imagenet.py)

def _run_cv(tmp_path, dataset, *extra):
    return cv_train.main([
        "--test", "--device", "cpu", "--dataset_name", dataset,
        "--dataset_dir", str(tmp_path / "ds"),
        "--local_momentum", "0.0", "--mode", "sketch",
        "--error_type", "virtual", "--virtual_momentum", "0.9",
        "--num_workers", "8", "--local_batch_size", "4",
        "--num_epochs", "0.05", "--valid_batch_size", "16",
        "--lr_scale", "0.1", *extra])


def test_cv_train_emnist_end_to_end(tmp_path, capsys):
    # ResNet9 on 28 x 28 x 1 images; EMNIST logs every round
    assert _run_cv(tmp_path, "EMNIST")
    out = capsys.readouterr().out
    assert "LR: " in out and "train_loss" in out


def test_cv_train_imagenet_end_to_end(tmp_path, capsys):
    assert _run_cv(tmp_path, "ImageNet")
    out = capsys.readouterr().out
    assert "train_loss" in out and "LR: " not in out
