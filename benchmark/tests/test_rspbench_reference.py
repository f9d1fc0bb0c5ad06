"""The plain reference held against the port's CPU path at a tiny size, in
float64 where the port computes in it, so that a wrong reference fails
here before it reaches the card. This file is not the reference: it
imports both."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import augment as ref_aug
from benchmark.reference import models, moco
from benchmark.run import make_queue, make_weights
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.moco import build_moco_model, init_moco_state
from rspnet_tpu_torch.moco import train_step
from rspnet_tpu_torch.ops.augment import augment_batch, sample_train_params

# every backbone file of the reference, found by name: a new one is held
# to the port here without an edit
ARCHS = models.available()
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _port_model(arch):
    cfg = ConfigTree.from_dict({
        "model": {"arch": arch},
        "moco": {"dim": 128, "k": 12, "m": 0.999, "t": 0.07,
                 "diff_speed": [2], "fc_type": "linear"},
        "temporal_transforms": {"size": 16}})
    model, mcfg = build_moco_model(cfg)
    return model, mcfg


def _pair(arch, seed=3):
    port, mcfg = _port_model(arch)
    ref = models.build(arch, 128)
    w = {k: (v.double() if v.is_floating_point() else v)
         for k, v in make_weights(arch, 128, seed, "cpu").items()}
    port = port.double()
    ref = ref.double()
    port.load_state_dict(w)
    ref.load_state_dict(w)
    return port, ref, mcfg, w


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_names_and_shapes(arch):
    port, _ = _port_model(arch)
    ref = models.build(arch, 128)
    ps, rs = port.state_dict(), ref.state_dict()
    assert set(ps) == set(rs)
    assert all(ps[k].shape == rs[k].shape for k in rs)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_gradient_f64(arch):
    port, ref, _, _ = _pair(arch)
    port.train()
    ref.train()
    x = torch.randn(3, 8, 48, 48, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    pa, pm = port(x)
    ra, rm = ref(x)
    torch.testing.assert_close(pa, ra, rtol=1e-9, atol=1e-11)
    torch.testing.assert_close(pm, rm, rtol=1e-9, atol=1e-11)
    w = torch.randn(3, 128, dtype=torch.float64)
    pg = torch.autograd.grad((pa * w).sum() + pm.sum(),
                             list(port.parameters()))
    rg = dict(zip([n for n, _ in ref.named_parameters()],
                  torch.autograd.grad((ra * w).sum() + rm.sum(),
                                      list(ref.parameters()))))
    # per leaf, by norm: at this size the batch norms see a few values
    # each, and float64 rounding grows to ~1e-7 in single elements
    for (n, _), g in zip(port.named_parameters(), pg):
        assert (g - rg[n]).norm() <= 1e-6 * rg[n].norm() + 1e-12, n


def test_augment_draws_and_pixels_match_port():
    clips = torch.randint(0, 256, (5, 6, 40, 48, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2))
    p = sample_train_params(np.random.default_rng(7), 5, [(40, 48)],
                            crop_area=(0.4, 1.0), h_flip=0.5, gray_p=0.2,
                            jitter=(0.4, 0.4, 0.4, 0.4))
    q = ref_aug.draw_params(np.random.default_rng(7), 5, 40, 48)
    np.testing.assert_array_equal(p.boxes, q.boxes)
    np.testing.assert_array_equal(p.flip, q.flip)
    np.testing.assert_array_equal(p.gray, q.gray)
    np.testing.assert_array_equal(p.jitter, q.factors)
    np.testing.assert_array_equal(p.order, q.order)
    out_port = augment_batch(clips, p, size=(32, 32), mean=MEAN, std=STD)
    out_ref = ref_aug.augment(clips, q, 32, MEAN, STD)
    # float32 on both sides, the sums in another order
    torch.testing.assert_close(out_ref, out_port, rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_f64_matches_port(arch):
    port, ref_q, mcfg, w = _pair(arch)
    B, lr, mom, wd = 4, 0.01, 0.9, 1e-4
    opt = torch.optim.SGD(port.parameters(), lr=lr, momentum=mom,
                          weight_decay=wd)
    state = init_moco_state(port, mcfg, opt, torch.Generator())
    queue = make_queue(128, 12, 5, "cpu").double()
    state.queue = queue.clone()
    gen = torch.Generator().manual_seed(9)
    views = [torch.randn(B, 16, 48, 48, 3, dtype=torch.float64,
                         generator=gen) for _ in range(2)]
    perm = torch.randperm(B, generator=gen)
    metrics = train_step(state, views[0], views[1], mcfg, perm=perm,
                         speed_index=0)

    ref_k = models.build(arch, 128).double()
    ref_k.load_state_dict(w)
    for p in ref_k.parameters():
        p.requires_grad_(False)
    c = moco.StepConfig(arch=arch, size=48, dim=128, m=0.999, t=0.07,
                        margin=2.0, lr=lr, momentum=mom, weight_decay=wd,
                        mean=MEAN, std=STD)
    ref_queue = queue.clone()
    bufs = {}
    loss, grads, keys, ptr = moco.step(ref_q, ref_k, ref_queue, 0,
                                       views[0], views[1], perm, bufs, c)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-9)
    ref_params = dict(ref_q.named_parameters())
    for n, p in port.named_parameters():
        g = opt.state[p]["momentum_buffer"] - wd * w[n]
        assert (g - grads[n]).norm() <= 1e-6 * grads[n].norm() + 1e-12, n
        assert (p - ref_params[n]).norm() <= 1e-9 * ref_params[n].norm(), n
    ref_kp = dict(ref_k.named_parameters())
    for n, p in state.model_k.named_parameters():
        torch.testing.assert_close(p, ref_kp[n], rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(state.queue, ref_queue, rtol=1e-9,
                               atol=1e-11)
    assert state.queue_ptr == ptr == B
