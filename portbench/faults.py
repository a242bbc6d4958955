"""Faults planted under the timed path, for the tests and the limits'
upper readings (portbench/calibrate.py); a benchmark run plants none.
Each is a callable the harness applies to the built FedModel; one that
patches a module returns the callable that undoes it.

  state_unchanged  the round step hands back the server state it was
                   given (only the round counter moves);
  half_batch       the second half of each round's clients is left out
                   (their masks zeroed), the mean taken over the rest;
  altered_update   the server's decoded update comes out doubled on the
                   first eighth of the coordinates;
  momentum_dropped each round starts from a zero momentum table, so the
                   virtual momentum (rho V) never acts;
  error_reset      each round starts from a zero error table, so the
                   error does not accumulate (E = V).
"""
from __future__ import annotations


def state_unchanged(model) -> None:
    inner = model._train_round

    def train_round(server, clients, batch, lr, key):
        new, clients, metrics = inner(server, clients, batch, lr, key)
        return server._replace(round_idx=new.round_idx), clients, metrics

    model._train_round = train_round


def half_batch(model) -> None:
    inner = model._train_round

    def train_round(server, clients, batch, lr, key):
        mask = batch.mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return inner(server, clients, batch._replace(mask=mask), lr, key)

    model._train_round = train_round


def altered_update(model) -> None:
    from commefficient_tpu_torch.federated import server as fserver
    inner = fserver.get_server_update

    def get_server_update(*args, **kwargs):
        upd = inner(*args, **kwargs)
        update = upd.update.clone()
        update[:update.shape[0] // 8] *= 2
        return upd._replace(update=update)

    # the round looks the function up in the module at each call
    fserver.get_server_update = get_server_update
    return lambda: setattr(fserver, "get_server_update", inner)


def _zeroed_before_each_round(model, field: str) -> None:
    inner = model._train_round

    def train_round(server, clients, batch, lr, key):
        zero = getattr(server, field).clone().zero_()
        return inner(server._replace(**{field: zero}), clients, batch, lr,
                     key)

    model._train_round = train_round


def momentum_dropped(model) -> None:
    _zeroed_before_each_round(model, "Vvelocity")


def error_reset(model) -> None:
    _zeroed_before_each_round(model, "Verror")


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_update": altered_update,
          "momentum_dropped": momentum_dropped, "error_reset": error_reset}
