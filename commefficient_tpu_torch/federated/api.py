"""Reference-shaped high-level API: FedModel + FedOptimizer, the port
of commefficient_tpu/federated/api.py (single process, no scheduler,
transport, state tiers, journal or scanned spans).

The call contract is the JAX package's:

    model = FedModel(module, loss_fn, cfg, device="cuda")
    opt = FedOptimizer(model)
    opt.param_groups[0]["lr"] = lr          # or a LambdaLR scheduler
    losses, *metrics, down, up = model((client_ids, (x, y), mask))
    opt.step()

`model(batch)` runs the whole round (client compute, cohort sum,
sketch, server step, weight update) with the learning rate set before
the call; `opt.step()` only exists for call-pattern parity. Losses and
metrics come back as tensors on the model's device; download/upload are
the round's per-client byte counts (numpy), accounted one round late
exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.federated import round as fround
from commefficient_tpu_torch.federated.accounting import (
    CommAccountant, pack_change_bits, to_words,
)
from commefficient_tpu_torch.ops.flat import flatten_params
from commefficient_tpu_torch.ops.prng import PRNGKey


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class FedModel:
    def __init__(self, module: torch.nn.Module, loss_train, cfg: Config,
                 loss_val=None, device="cuda",
                 num_clients: Optional[int] = None,
                 lr_scale_vec: Optional[np.ndarray] = None):
        """module: the torch model (its flat vector is laid out as the
        JAX package's, ops/flat.py). loss_*: loss_fn(params, batch_tuple,
        mask) -> (loss, metrics), with `params` the {name: tensor} dict
        for torch.func.functional_call. lr_scale_vec: an optional [D]
        per-parameter learning-rate scale (the Fixup nets' parameter
        groups); the round then takes lr x that vector, in every mode."""
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.training = True
        vec, self.unravel = flatten_params(self.module)
        cfg = cfg.replace(grad_size=int(vec.shape[0])).validate()
        self.cfg = cfg
        self.num_clients = cfg.resolved_num_clients(num_clients)
        self._train_round = fround.make_train_fn(loss_train, self.unravel,
                                                 cfg)
        self._eval_batch = fround.make_eval_fn(
            loss_val if loss_val is not None else loss_train,
            self.unravel, cfg)
        self.server = fround.init_server_state(cfg, vec)
        self.clients = fround.init_client_state(cfg, self.num_clients,
                                                self.device, vec)
        self.accountant = CommAccountant(cfg, self.num_clients)
        # the run's threefry key; every round folds in its index
        self._key = PRNGKey(cfg.seed)
        self.lr_scale_vec = (None if lr_scale_vec is None
                             else _as_tensor(np.asarray(lr_scale_vec,
                                                        np.float32),
                                             self.device))
        # the previous round's packed change bits, still on the device
        self._prev_change_bits: Optional[torch.Tensor] = None
        self._optimizer: Optional["FedOptimizer"] = None

    def train(self, training: bool):
        self.training = training

    def __call__(self, batch):
        if self.training:
            return self._call_train(batch)
        return self._call_val(batch)

    def finalize(self):
        """Nothing to tear down; kept for API parity."""

    @property
    def ps_weights(self) -> torch.Tensor:
        return self.server.ps_weights

    def _lr(self):
        """The scheduler's learning rate: a float, or a [D] tensor with
        a per-parameter scale vector."""
        if self._optimizer is None:
            raise RuntimeError("attach a FedOptimizer before training")
        lr = float(self._optimizer.param_groups[0]["lr"])
        if self.lr_scale_vec is not None:
            return lr * self.lr_scale_vec
        return lr

    def _call_train(self, batch):
        """batch = (client_ids [W], data tuple of [W, B, ...],
        mask [W, B])."""
        client_ids, data, mask = batch
        ids_host = np.asarray(client_ids).reshape(-1)
        # the previous round's change bits come to the host BEFORE this
        # round is queued, so the copy waits on that round only
        prev_words = (None if self._prev_change_bits is None
                      else to_words(self._prev_change_bits))
        placed = fround.RoundBatch(
            _as_tensor(ids_host.astype(np.int64), self.device),
            tuple(_as_tensor(d, self.device) for d in data),
            _as_tensor(mask, self.device).to(torch.float32))
        prev_weights = self.server.ps_weights
        self.server, self.clients, metrics = self._train_round(
            self.server, self.clients, placed, self._lr(), self._key)
        self._prev_change_bits = pack_change_bits(
            self.server.ps_weights - prev_weights)
        download, upload = self.accountant.record_round(ids_host,
                                                        prev_words)
        return [metrics.losses, *metrics.metrics, download, upload]

    def _call_val(self, batch):
        """batch = (data tuple of [S, vb, ...], mask [S, vb]); returns
        per-shard [loss, *metrics, count] as numpy arrays."""
        data, mask = batch
        loss, mets, count = self._eval_batch(
            self.server.ps_weights,
            tuple(_as_tensor(d, self.device) for d in data),
            _as_tensor(mask, self.device).to(torch.float32))
        return [loss.cpu().numpy(), *[m.cpu().numpy() for m in mets],
                count.cpu().numpy()]


class FedOptimizer:
    """Holds param_groups for LR scheduling; the server update itself
    runs inside FedModel's round."""

    def __init__(self, model: FedModel, cfg: Optional[Config] = None):
        self.model = model
        self.cfg = cfg or model.cfg
        self.param_groups = [{"lr": 0.0}]
        model._optimizer = self

    def step(self):
        """No-op kept for call-pattern parity: the weight update already
        happened inside model(batch)."""

    def zero_grad(self):
        raise NotImplementedError(
            "gradients are per-round temporaries in the fused design")
