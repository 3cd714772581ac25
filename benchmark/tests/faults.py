"""Faults planted in the program under a run, to show that the check
catches them: each is a context manager that patches the program's own
functions where the timed path calls them.

Serving: ``altered_answer`` turns every part's pose by ``angle`` degrees
about z where the poses are produced; ``half_batch`` samples only the
first half of the pairs and returns the noise for the rest. Training:
``unchanged_state`` returns the state it is given; ``half_batch`` takes the
loss's mean over the first sample slot alone; ``doubled_update`` moves the
first leaf twice as far.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


@contextlib.contextmanager
def _patched(module, name: str, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def altered_answer(angle: float = 10.0):
    from rap_tpu_torch import registration

    c, s = math.cos(math.radians(angle)), math.sin(math.radians(angle))

    def make(old):
        def predict_poses(batch, points):
            R, t = old(batch, points)
            Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=R.device)
            return Rz @ R, t
        return predict_poses
    return _patched(registration, "predict_poses", make)


def serving_half_batch():
    from rap_tpu_torch import registration

    def make(old):
        def sample(params, cfg, batch, *args, x_1=None, **kw):
            half = batch.G // 2
            fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
            part = {k: (v[:half] if torch.is_tensor(v) and v.shape[:1] == (batch.G,) else
                        v[:batch.S // 2] if torch.is_tensor(v) and v.shape[:1] == (batch.S,)
                        else v) for k, v in fields.items()}
            out = old(params, cfg, type(batch)(**part), *args, x_1=x_1[:half], **kw)
            out["points"] = torch.cat([out["points"], x_1[half:]])
            return out
        return sample
    return _patched(registration, "sample", make)


def unchanged_state():
    from rap_tpu_torch.train import step as step_mod

    def make(old):
        def make_train_step(*a, **kw):
            inner = old(*a, **kw)

            def step(state, batch, *args, **kwargs):
                return state, inner(state, batch, *args, **kwargs)[1]
            return step
        return make_train_step
    return _patched(step_mod, "make_train_step", make)


def training_half_batch():
    from rap_tpu_torch.train import step as step_mod

    def make(old):
        def training_forward(params, cfg, batch, *args, **kw):
            P = batch.G // batch.S
            keep = torch.arange(batch.G, device=batch.device)[:, None] < P
            return old(params, cfg, dataclasses.replace(
                batch, point_mask=batch.point_mask & keep), *args, **kw)
        return training_forward
    return _patched(step_mod, "training_forward", make)


def doubled_update():
    from rap_tpu_torch.train import step as step_mod

    def make(old):
        def apply_updates(params, updates):
            first = next(iter(updates))
            return old(params, {k: (2.0 * u if k == first else u) for k, u in updates.items()})
        return apply_updates
    return _patched(step_mod, "apply_updates", make)


FAULTS = {
    "rap_12.pairs-serve": {"altered_answer": altered_answer, "half_batch": serving_half_batch},
    "rap_10.multiview-train": {"unchanged_state": unchanged_state,
                               "half_batch": training_half_batch,
                               "doubled_update": doubled_update},
}
