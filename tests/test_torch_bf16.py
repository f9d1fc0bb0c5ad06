"""bf16 compute in the port against the JAX package built with
``dtype=jnp.bfloat16``, on the CPU.

On the card the port computes in bf16, as the JAX engine does on its
accelerator: parameters and BN statistics f32, each conv and dense in bf16.
Every module here runs the same numpy-seeded, bf16-representable inputs
through the JAX module and the port's, with weights carried over by
``models/convert.py``. Tolerances are in bf16 ulps:
``ulp_bf16(v) = 2**(floor(log2(max(|v|, 2**-126))) - 7)``.

- Modules (``ConvBN`` on a bf16 input and on the f32 input the stem
  takes, a gated ``SepConv``, one ``SepInc``): bit-equal in
  all but 1% of cells, and within 2 ulps everywhere (ulps of the cell, or
  of the output's RMS where the cell is smaller).
  A port that leaves out one rounding point of the JAX code (the conv's
  output, the excitation conv's output before its bias, the gate) is
  unequal in 2-30% of cells. XLA's CPU ``logistic`` is not correctly
  rounded in bf16 (it rounds exp, 1 + exp and the quotient: up to 2 ulps),
  while ``torch.sigmoid`` rounds once, where the JAX code names one
  rounding point; so these tests give the JAX side a correctly rounded
  sigmoid, and one more test holds the gated ``SepConv`` to the
  unchanged XLA logistic within 4 ulps.
- Heads (``LinearFc`` + ``l2_normalize``): within 2 ulps and bit-equal in
  all but 8% (rounding the norm once, or adding the bias
  inside the product, is unequal in 18-33%).
- ``avid_loss_dense`` with bf16 heads and an f32 queue: the f32 logits and
  loss at rtol 1e-6 (bf16 positive logits are exact in f32; summing them
  in f32 is 5 bf16 ulps off).
- The whole objective (``moco_objective`` through ``eval_step``) on given
  bf16 embeddings, against ``make_eval_step``: an encoder that returns
  frames of its input as the two heads' outputs stands in for the model
  on both sides. The bf16 ranking loss equal bit for bit, the f32 losses
  at rtol 1e-6, the accuracies equal.
- One train step, bf16 against f64, beside JAX's bf16 step against its f64
  step: the port's error lies within 0.5x-2x of JAX's for the updated
  ``params_q`` and for the losses (RMS over the three losses and a few
  input batches: one batch's scalar error is one draw of rounding noise),
  and the accuracies flip against f64 at most twice as often as JAX's,
  plus one. A port still in f32 has no error; one that rounds more, more.
  The encoder is S3D-G's own stem (sepConv1, maxPool1, basicConv3d,
  sep_conv2, maxPool2, sepInc_3b) of both packages: at test widths the
  whole S3D-G's bf16 output is 50-70% off its f64 output (each inception
  block multiplies the relative error by about 1.4, in both packages), so
  the two errors there are noise of the same size whatever was rounded.
  The port's step runs with oneDNN off: on a CPU with AVX512-BF16,
  oneDNN's bf16 weight gradient of a temporal convolution whose kernel is
  longer than its input (sepConv1's (7, 1, 1) over the stem's 4 frames)
  is garbage, off by up to 1e17 of its norm; ATen's own CPU convolution
  is within 0.4% of f64 there, as the card's cuDNN is.
"""
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from rspnet_tpu.models.common import ConvBN as JaxConvBN
from rspnet_tpu.models.common import max_pool3d as jax_max_pool3d
from rspnet_tpu.models.s3dg import SepConv as JaxSepConv
from rspnet_tpu.models.s3dg import SepInc as JaxSepInc
from rspnet_tpu.moco import MoCoConfig as JaxMoCoConfig
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu.moco.builder import MoCoState as JaxState
from rspnet_tpu.moco.builder import (_avid_loss_dense, make_eval_step,
                                     make_train_step)
from rspnet_tpu.moco.wrapper import LinearFc as JaxLinearFc
from rspnet_tpu.moco.wrapper import _l2_normalize
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
from rspnet_tpu_torch.models import convert
from rspnet_tpu_torch.models.common import ConvBN
from rspnet_tpu_torch.models.s3dg import S3DG, SepConv, SepInc
from rspnet_tpu_torch.moco import MoCoConfig, MoCoState, MultiTaskWrapper
from rspnet_tpu_torch.moco.step import avid_loss_dense, eval_step, train_step
from rspnet_tpu_torch.moco.wrapper import LinearFc, l2_normalize
from tests.test_step_parity import enable_x64

torch.set_num_threads(1)
BF = torch.bfloat16
_BN = dict(bn_eps=1e-3, bn_momentum=0.999)


def ulp_bf16(v):
    v = np.abs(np.asarray(v, np.float64))
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 2.0 ** -126))) - 7)


def _within_ulps(got, ref, n) -> bool:
    """|got - ref| <= n ulps of the cell's value, or of the tensor's RMS
    where the cell is smaller (a cell near 0 after a cancellation carries
    the rounding error of its operands)."""
    rms = np.sqrt(np.mean(np.square(ref, dtype=np.float64)))
    return bool(np.all(np.abs(got - ref)
                       <= n * ulp_bf16(np.maximum(np.abs(ref), rms))))


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """f32 array of the bf16 values nearest to ``a``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF).float().numpy()


def _correctly_rounded_logistic(v):
    return jax.nn.sigmoid(v.astype(jnp.float32)).astype(v.dtype)


@pytest.fixture
def exact_logistic(monkeypatch):
    monkeypatch.setattr(fnn, "sigmoid", _correctly_rounded_logistic)


def _perturbed(tree, rng):
    """Parameters moved off their init (BN scale 1 / bias 0), in f32."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(
            np.float32), tree)


def _converted(mapping, variables) -> dict:
    """JAX variables (numpy leaves) -> state_dict entries through a
    mapping of convert.py."""
    out = {}
    for key_t, (coll, path_f, conv) in mapping:
        v = np.asarray(convert._get_path(variables[coll], path_f))
        out[key_t] = conv(v) if conv is not None else v
    return out


C_IN = 16
_SEP_OC = [8, 8, 16, 4, 8, 8]
MODULES = {
    # the stem's case: K3's f32 output, cast by the conv
    "convbn_f32_input": (lambda: JaxConvBN(24, (1, 3, 3), 1, (0, 1, 1), **_BN,
                                           dtype=jnp.bfloat16),
                         lambda: ConvBN(C_IN, 24, (1, 3, 3), 1, (0, 1, 1),
                                        **_BN, dtype=BF),
                         lambda: convert._convbn("m", "m")),
    "convbn": (lambda: JaxConvBN(24, (1, 3, 3), 1, (0, 1, 1), **_BN,
                                 dtype=jnp.bfloat16),
               lambda: ConvBN(C_IN, 24, (1, 3, 3), 1, (0, 1, 1), **_BN,
                              dtype=BF),
               lambda: convert._convbn("m", "m")),
    "sepconv": (lambda: JaxSepConv(24, 3, 1, 1, gate=True,
                                   dtype=jnp.bfloat16),
                lambda: SepConv(C_IN, 24, 3, 1, 1, True, BF),
                lambda: convert._sepconv_mapping("m", "m", True)),
    "sepinc": (lambda: JaxSepInc(_SEP_OC, gate=True, dtype=jnp.bfloat16),
               lambda: SepInc(C_IN, _SEP_OC, True, BF),
               lambda: convert._sepinc_mapping("m", "m", True)),
}


def _module_outputs(which: str):
    """Train-mode forward of the JAX module and the port's on one input:
    (port out, JAX out, port BN statistics, JAX BN statistics), as f32
    NDHWC numpy arrays and state_dict-named dicts."""
    jax_mod, port_mod, mapping = MODULES[which]
    rng = np.random.RandomState(0)
    x = (np.maximum(rng.randn(2, 4, 10, 10, C_IN), 0)
         + 0.1 * rng.randn(2, 4, 10, 10, C_IN)).astype(np.float32)
    if which.endswith("f32_input"):
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    else:
        x = _bf16_values(x)
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF)
    jm = jax_mod()
    v = jm.init(jax.random.PRNGKey(0), xj, train=False)
    v = {"params": _perturbed(v["params"], rng),
         "batch_stats": v["batch_stats"]}
    out, mut = jm.apply(v, xj, train=True, mutable=["batch_stats"])
    assert out.dtype == jnp.bfloat16
    # both modules under the name "m", so convert.py's mappings apply
    port = nn.ModuleDict({"m": port_mod()})
    convert.load_converted(port, _converted(
        mapping(), {"params": {"m": v["params"]},
                    "batch_stats": {"m": v["batch_stats"]}}))
    port.train()
    got = port["m"](xt.permute(0, 4, 1, 2, 3))
    assert got.dtype == BF
    stats_j = _converted([e for e in mapping() if e[1][0] == "batch_stats"],
                         {"batch_stats": {"m": mut["batch_stats"]}})
    stats_p = {k: b.numpy() for k, b in port.named_buffers()
               if k in stats_j}
    return (got.permute(0, 2, 3, 4, 1).float().detach().numpy(),
            np.asarray(out.astype(jnp.float32)), stats_p, stats_j)


@pytest.mark.parametrize("which", sorted(MODULES))
def test_bf16_module_matches_jax(which, exact_logistic):
    got, ref, stats_p, stats_j = _module_outputs(which)
    assert _within_ulps(got, ref, 2)
    assert np.mean(got != ref) <= 0.01, np.mean(got != ref)
    # BN statistics stay f32 and see the same bf16 conv outputs
    assert stats_p and set(stats_p) == set(stats_j)
    for k, ref_s in stats_j.items():
        assert stats_p[k].dtype == np.float32, k
        np.testing.assert_allclose(stats_p[k], ref_s, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_bf16_gate_within_xla_logistic():
    """The gated SepConv against the JAX module as it stands: XLA's bf16
    logistic is up to 2 ulps off the rounded sigmoid, and the product with
    the gate rounds once more."""
    got, ref, _, _ = _module_outputs("sepconv")
    assert _within_ulps(got, ref, 4)


def test_bf16_heads_match_jax():
    rng = np.random.RandomState(1)
    feat = _bf16_values(np.abs(rng.randn(64, 2, 3, 3, 64)))
    jm = JaxLinearFc(16, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(feat, jnp.bfloat16))
    v = {"params": _perturbed(v["params"], rng)}
    ref = _l2_normalize(jm.apply(v, jnp.asarray(feat, jnp.bfloat16)))
    assert ref.dtype == jnp.bfloat16
    head = LinearFc(64, 16, BF)
    lin = v["params"]["linear"]
    convert.load_converted(head, {
        "linear.weight": convert._dense_w(np.asarray(lin["kernel"])),
        "linear.bias": np.asarray(lin["bias"])})
    got = l2_normalize(head(torch.from_numpy(feat).permute(0, 4, 1, 2, 3)
                            .to(BF)))
    assert got.dtype == BF
    got = got.float().detach().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert _within_ulps(got, ref, 2)
    assert np.mean(got != ref) <= 0.08, np.mean(got != ref)


def test_bf16_avid_loss_matches_jax():
    rng = np.random.RandomState(2)

    def unit(shape):
        a = rng.randn(*shape)
        return _bf16_values(a / np.linalg.norm(a, axis=1, keepdims=True))

    q, k, k_neg = unit((8, 16)), unit((8, 16)), unit((8, 16))
    queue = rng.randn(16, 32)
    queue = (queue / np.linalg.norm(queue, axis=0, keepdims=True)).astype(
        np.float32)
    loss_j, logits_j = _avid_loss_dense(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, k_neg)),
        jnp.asarray(queue), JaxMoCoConfig(dim=16, k=32))
    loss_p, logits_p = avid_loss_dense(
        *(torch.from_numpy(a).to(BF) for a in (q, k, k_neg)),
        torch.from_numpy(queue), MoCoConfig(dim=16, k=32))
    assert loss_p.dtype == torch.float32 and loss_j.dtype == jnp.float32
    for got, ref in zip(logits_p, logits_j):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-6)


class _FramesAsHeads(nn.Module):
    """Encoder stand-in: frame 1's first pixel as the A-VID head, its second
    as the RSP head ([B, T, 1, 2, dim] -> two [B, dim] in bf16)."""

    def forward(self, x):
        return x[:, 1, 0, 0].to(BF), x[:, 1, 0, 1].to(BF)


class _JaxFramesAsHeads:
    @staticmethod
    def apply(variables, x, train=False):
        del variables, train
        return (x[:, 1, 0, 0].astype(jnp.bfloat16),
                x[:, 1, 0, 1].astype(jnp.bfloat16))


def test_bf16_objective_matches_jax():
    rng = np.random.RandomState(3)
    b, dim, k = 8, 16, 32
    x = rng.randn(2, b, 4, 1, 2, dim)
    x = _bf16_values(x / np.linalg.norm(x, axis=-1, keepdims=True))
    queue = rng.randn(dim, k)
    queue = (queue / np.linalg.norm(queue, axis=0, keepdims=True)).astype(
        np.float32)
    jcfg = JaxMoCoConfig(dim=dim, k=k, t=0.07, diff_speed=(2,), margin=2.0)
    key = jax.random.PRNGKey(5)
    # make_eval_body draws from the key itself (step_core.py:396-398)
    perm = np.array(jax.random.permutation(jax.random.split(key)[0], b))
    state = JaxState(params_q={}, params_k={}, batch_stats_q={},
                     batch_stats_k={}, queue=jnp.asarray(queue),
                     queue_ptr=jnp.zeros((), jnp.int32), opt_state=None,
                     step=jnp.zeros((), jnp.int32))
    ref = make_eval_step(_JaxFramesAsHeads, jcfg, axis_name=None)(
        state, jnp.asarray(x[0]), jnp.asarray(x[1]), key)
    pstate = MoCoState(_FramesAsHeads(), _FramesAsHeads(),
                       torch.from_numpy(queue), 0, None)
    got = eval_step(pstate, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                    MoCoConfig(dim=dim, k=k, t=0.07),
                    perm=torch.from_numpy(perm), speed_index=0)
    assert ref["loss_M"].dtype == jnp.bfloat16
    assert float(got["loss_M"]) == float(ref["loss_M"])
    for name in ("loss", "loss_A"):
        np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                   rtol=1e-6, err_msg=name)
    for name in ("acc1_A", "acc5_A", "acc1_A_n", "acc5_A_n", "acc1_M"):
        assert float(got[name]) == float(ref[name]), name


# ---------------------------------------------------------------------------
# one train step: the bf16 error budget
# ---------------------------------------------------------------------------

B, T, S, DIM, K = 4, 16, 32, 8, 16
N_BATCHES = 6
STEM = 6            # S3D-G's first six feature layers: up to sepInc_3b


class JaxStem(fnn.Module):
    """The JAX S3D-G's first six feature layers (rspnet_tpu/models/s3dg.py
    S3DG.features up to inc3b), as a MultiTaskWrapper encoder."""
    num_classes: int = 1
    with_classifier: bool = False
    dtype: Any = None
    axis_name: Any = None

    def setup(self):
        sep = dict(gate=True, dtype=self.dtype, axis_name=self.axis_name)
        self.sepConv1 = JaxSepConv(64, 7, 2, 3, **sep, name="sepConv1")
        self.basicConv3d = JaxConvBN(64, 1, 1, 0, **_BN, dtype=self.dtype,
                                     axis_name=self.axis_name,
                                     name="basicConv3d")
        self.sepConv2 = JaxSepConv(192, 3, 1, 1, **sep, name="sepConv2")
        self.inc3b = JaxSepInc([64, 96, 128, 16, 32, 32], **sep,
                               name="inc3b")

    def features(self, x, train: bool = False):
        x = self.sepConv1(x, train)
        x = jax_max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.basicConv3d(x, train)
        x = self.sepConv2(x, train)
        x = jax_max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        return self.inc3b(x, train)


def _stem_state_dict(variables) -> dict:
    """JAX wrapper variables (numpy) -> the port's stem wrapper's
    state_dict entries."""
    m = convert._sepconv_mapping("feature.sepConv1", "sepConv1", True)
    m += convert._convbn("feature.basicConv3d", "basicConv3d")
    m += convert._sepconv_mapping("feature.sep_conv2", "sepConv2", True)
    m += convert._sepinc_mapping("feature.sepInc_3b", "inc3b", True)
    out = _converted([("encoder." + k, (c, "encoder/" + p, f))
                      for k, (c, p, f) in m], variables)
    for head in ("fc1", "fc2"):
        lin = variables["params"][head]["linear"]
        out[f"{head}.linear.weight"] = convert._dense_w(
            np.asarray(lin["kernel"]))
        out[f"{head}.linear.bias"] = np.asarray(lin["bias"])
    return out


def _port_stem(dtype, variables) -> MultiTaskWrapper:
    enc = S3DG(dtype=dtype)
    enc.feature = enc.feature[:STEM]
    enc.feature_dim = 256
    net = MultiTaskWrapper(enc, num_classes=DIM, dtype=dtype)
    net = net.to(memory_format=torch.channels_last_3d)
    convert.load_converted(net, _stem_state_dict(variables))
    return net


def _tree(t, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), t)


def test_bf16_train_step_error_budget():
    rng = np.random.RandomState(0)
    jm = JaxWrapper(encoder_factory=JaxStem, num_classes=DIM,
                    fc_type="linear", axis_name=None)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, T // 2, S, S, 3)),
                train=False)
    params_q = _perturbed(v["params"], rng)
    params_k = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        params_q)
    stats = _tree(v["batch_stats"], np.float32)
    queue = rng.randn(DIM, K)
    queue = (queue / np.linalg.norm(queue, axis=0, keepdims=True)).astype(
        np.float32)
    cfg = JaxMoCoConfig(dim=DIM, k=K, m=0.999, t=0.07, diff_speed=(2,),
                        fc_type="linear", margin=2.0)
    opt = optax.chain(optax.add_decayed_weights(1e-4),
                      optax.sgd(0.05, momentum=0.9))
    steps = {}

    def jax_step(dtype, np_dtype, x_q, x_k, key):
        if dtype not in steps:
            model = JaxWrapper(encoder_factory=JaxStem, num_classes=DIM,
                               fc_type="linear", axis_name=None, dtype=dtype)
            steps[dtype] = jax.jit(make_train_step(model, opt, cfg,
                                                   axis_name=None))
        pq = _tree(params_q, np_dtype)
        state = JaxState(params_q=pq, params_k=_tree(params_k, np_dtype),
                         batch_stats_q=_tree(stats, np_dtype),
                         batch_stats_k=_tree(stats, np_dtype),
                         queue=jnp.asarray(queue.astype(np_dtype)),
                         queue_ptr=jnp.zeros((), jnp.int32),
                         opt_state=opt.init(pq),
                         step=jnp.zeros((), jnp.int32))
        new, metrics = steps[dtype](state, jnp.asarray(x_q.astype(np_dtype)),
                                    jnp.asarray(x_k.astype(np_dtype)), key)
        return (_stem_state_dict({"params": _tree(new.params_q, np.float64),
                                  "batch_stats": stats}),
                {k: float(m) for k, m in metrics.items()})

    err_j, err_p = {}, {}
    for i in range(N_BATCHES):
        brng = np.random.RandomState(100 + i)
        x_q = brng.randn(B, T, S, S, 3).astype(np.float32)
        x_k = brng.randn(B, T, S, S, 3).astype(np.float32)
        key = jax.random.PRNGKey(7 + i)
        # the JAX step's own draws (step_core.py:314-315, :181-205)
        key_perm, _ = jax.random.split(jax.random.split(key)[0])
        perm = np.array(jax.random.permutation(key_perm, B))

        with enable_x64():
            p64, m64 = jax_step(None, np.float64, x_q, x_k, key)
        pj, mj = jax_step(jnp.bfloat16, np.float32, x_q, x_k, key)

        net_q = _port_stem(BF, {"params": params_q, "batch_stats": stats})
        net_k = _port_stem(BF, {"params": params_k, "batch_stats": stats})
        for p in net_k.parameters():
            p.requires_grad_(False)
        sgd = build_optimizer(ConfigTree.from_dict(
            {"lr": 0.05, "momentum": 0.9, "dampening": 0, "nesterov": False,
             "weight_decay": 1e-4}), net_q.parameters(), 0.05)
        state = MoCoState(net_q, net_k, torch.from_numpy(queue.copy()), 0,
                          sgd)
        with torch.backends.mkldnn.flags(enabled=False):  # docstring
            mp = train_step(state, torch.from_numpy(x_q),
                            torch.from_numpy(x_k),
                            MoCoConfig(dim=DIM, k=K, m=0.999, t=0.07),
                            perm=torch.from_numpy(perm), speed_index=0)
        assert state.queue.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in net_q.parameters())
        assert all(m.dtype == torch.float32 for m in mp.values())
        got = {k: p.detach().double().numpy()
               for k, p in net_q.named_parameters()}
        for name, ref in m64.items():
            err_j.setdefault(name, []).append(mj[name] - ref)
            err_p.setdefault(name, []).append(float(mp[name]) - ref)
        err_j.setdefault("params_q", []).append(
            np.sqrt(sum(((pj[k] - p64[k]) ** 2).sum() for k in got)))
        err_p.setdefault("params_q", []).append(
            np.sqrt(sum(((got[k] - p64[k]) ** 2).sum() for k in got)))

    def rms(errs, names):
        return float(np.sqrt(np.mean(np.square([errs[n] for n in names]))))

    for names in (["params_q"], ["loss", "loss_A", "loss_M"]):
        ej, ep = rms(err_j, names), rms(err_p, names)
        assert ej > 0
        assert 0.5 * ej <= ep <= 2.0 * ej, (names, ep, ej)
    # accuracies move in steps of 100 / B: count the flips
    accs = [n for n in err_j if n.startswith("acc")]
    flips_j = sum(np.count_nonzero(err_j[n]) for n in accs)
    flips_p = sum(np.count_nonzero(err_p[n]) for n in accs)
    assert flips_p <= 2 * flips_j + 1, (flips_p, flips_j)
