"""Faults planted under the engine, to show that ``correct`` catches them
(the CPU tests) and to read the compared numbers under each at a cell's
own size on the card (``control.py --fault``): a wrapper of the program's
``train_step`` for each fault a one-card training cell can have, and of
its OpenCV decoder for the decoded clips."""
from __future__ import annotations

import copy

import torch


def state_unchanged(real):
    """A step that computes its metrics and returns the state unchanged."""
    def step(state, im_q, im_k, cfg, **kw):
        saved = (copy.deepcopy(state.model_q.state_dict()),
                 copy.deepcopy(state.model_k.state_dict()),
                 state.queue.clone(), state.queue_ptr,
                 copy.deepcopy(state.optimizer.state_dict()))
        metrics = real(state, im_q, im_k, cfg, **kw)
        state.model_q.load_state_dict(saved[0])
        state.model_k.load_state_dict(saved[1])
        state.queue.copy_(saved[2])
        state.queue_ptr = saved[3]
        state.optimizer.load_state_dict(saved[4])
        return metrics
    return step


def half_batch(real):
    """Half of the batch left out: the step's means over the rest."""
    def step(state, im_q, im_k, cfg, **kw):
        h = im_q.shape[0] // 2
        return real(state, im_q[:h], im_k[:h], cfg, **kw)
    return step


def keys_altered(real):
    """The keys the step enqueues altered where they are produced (each
    written to its neighbour's column)."""
    def step(state, im_q, im_k, cfg, **kw):
        ptr = state.queue_ptr
        metrics = real(state, im_q, im_k, cfg, **kw)
        b = im_q.shape[0]
        with torch.no_grad():
            state.queue[:, ptr:ptr + b] = state.queue[:, ptr:ptr + b].roll(
                1, dims=1)
        return metrics
    return step


def frames_bgr(real):
    """Decoded frames handed on in OpenCV's BGR order."""
    def get_batch(self, indices, out_wh=None):
        return real(self, indices, out_wh)[..., ::-1].copy()
    return get_batch


STEP_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
               "keys_altered": keys_altered}
FAULTS = {**STEP_FAULTS, "frames_bgr": frames_bgr}


def plant(name: str):
    """Plant the fault ``name`` under the engine; returns a function that
    undoes it."""
    if name in STEP_FAULTS:
        from rspnet_tpu_torch.engines import pretrain as owner
        attr = "train_step"
    else:
        from rspnet_tpu_torch.data.video_reader import CvVideoReader as owner
        attr = "get_batch"
    real = getattr(owner, attr)
    setattr(owner, attr, FAULTS[name](real))

    def undo():
        setattr(owner, attr, real)
    return undo
