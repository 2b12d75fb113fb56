"""The port's data-parallel layer (kd_cheap_conv_tpu_torch.parallel and the
`*_sharded` wrappers) on a 2-rank gloo group on the CPU, against the JAX
package's `*_sharded` functions on a 2-device mesh and against the port's
own one-process run.

- One module-scoped fixture spawns the 2 ranks (a FileStore under the
  test's tmp dir, a 60 s timeout, joined with a timeout). They import torch
  and the port only, run every case on their rows of the global batch and
  write their results to files. The JAX references run once in the parent
  on `make_mesh(jax.devices()[:2])` of the conftest's 8 virtual CPU
  devices, their Pallas kernels in interpret mode.
- Each wrapper (the stem in a0 and f0 mode, the IR chain, the decoder head,
  the upsample, the upsampled loss with KL and CE-only, the
  full-resolution loss): forward values, global moments, the loss, the
  input gradient (the ranks' rows joined) and the parameter gradients (the
  ranks' shares summed), at the shapes and tolerances of
  tests/test_sharded_kernels.py (the head's from tests/test_torch_head.py).
- The upsample on each rank equals the unsharded call on its rows, bit for
  bit; `BatchNorm` on constant per-rank blocks (per-rank variance 0) gives
  the one-process output and running variance; one tiny KD step (2 ranks x
  2 images at 33²) against the one-process step on the 4 images: loss,
  running statistics, summed gradients, weights after SGD, identical on
  both ranks.
- World size 1: with `torch.distributed.all_reduce` made to raise, each
  wrapper, the BN and the KD step under a group of one rank make no call
  and equal the unsharded functions bit for bit.
- A dead rank makes the other's collective raise within its timeout;
  `main.py` with the --multihost flags runs 2 ranks as 2 processes that
  print the same losses, and refuses a batch that does not divide and an
  Xception model under 2 ranks.
"""

from __future__ import annotations

import contextlib
import functools
import multiprocessing as mp
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 2
EPS = 1e-5
TIMEOUT_S = 60.0
JOIN_S = 120.0
REPO = Path(__file__).resolve().parents[1]

VAL = dict(rtol=1e-4, atol=1e-4)
SUM = dict(rtol=1e-4, atol=1e-5)
DX = dict(rtol=2e-3, atol=2e-4)
DP = dict(rtol=2e-3, atol=2e-3)
LOSS_G = dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the data: one global batch of 8 a case, from seeds, numpy
# ---------------------------------------------------------------------------

def _stem_params(seed=0):
    rng = np.random.RandomState(seed)
    p = {"k1": rng.randn(32, 9) * 0.5, "w1": rng.randn(16, 32) * 0.3,
         "w2": rng.randn(96, 16) * 0.3, "k2": rng.randn(96, 9) * 0.5,
         "w3": rng.randn(24, 96) * 0.2}
    for i, c in enumerate([32, 32, 16, 96, 96, 24]):
        p[f"g{i}"] = 1.0 + 0.3 * rng.randn(c)
        p[f"b{i}"] = 0.2 * rng.randn(c)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _ir_params(seed=7):
    from kd_cheap_conv_tpu_torch.ops.irchain import _BLOCKS

    rng = np.random.RandomState(seed)
    p = {}
    for i, (_, cin, ce, cout, _) in enumerate(_BLOCKS):
        p[f"we{i}"] = rng.randn(ce, cin) * 0.3
        p[f"k{i}"] = rng.randn(ce, 9) * 0.5
        p[f"wp{i}"] = rng.randn(cout, ce) * 0.2
        for tag, c in (("e", ce), ("d", ce), ("p", cout)):
            p[f"g{tag}{i}"] = 1.0 + 0.3 * rng.randn(c)
            p[f"b{tag}{i}"] = 0.2 * rng.randn(c)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _head_params(rng, ci, cm, nc):
    return {"k": (0.4 * rng.randn(ci, 9)).astype(np.float32),
            "pw": (0.2 * rng.randn(cm, ci)).astype(np.float32),
            "g": (1 + 0.2 * rng.randn(cm)).astype(np.float32),
            "b": (0.1 * rng.randn(cm)).astype(np.float32),
            "wc": (0.3 * rng.randn(nc, cm)).astype(np.float32),
            "bc": (0.1 * rng.randn(nc)).astype(np.float32)}


def _labels(rng, n, c, hw, void=0.2):
    lbl = rng.randint(0, c, (n, hw, hw)).astype(np.int64)
    lbl[rng.rand(n, hw, hw) < void] = 255
    return lbl


@functools.cache
def _case_data(case):
    """(batch arrays, split over the ranks by rows; params, whole on every
    rank). Shapes of tests/test_sharded_kernels.py."""
    rng = np.random.RandomState(7)
    if case == "stem":
        return ({"x": rng.randn(8, 17, 17, 32).astype(np.float32),
                 "w": rng.randn(8, 9, 9, 24).astype(np.float32)},
                _stem_params())
    if case == "stem_f0":
        p = _stem_params()
        p["w0"] = (0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32)  # HWIO
        return ({"x": rng.randn(8, 17, 17, 3).astype(np.float32),
                 "w": rng.randn(8, 5, 5, 24).astype(np.float32)}, p)
    if case == "ir":
        return ({"x": rng.randn(8, 17, 17, 24).astype(np.float32),
                 "w": rng.randn(8, 9, 9, 32).astype(np.float32),
                 "w_low": rng.randn(8, 17, 17, 24).astype(np.float32)},
                _ir_params())
    if case == "head":
        x = rng.randn(8, 9, 11, 24).astype(np.float32)
        return ({"low": x[..., :8].copy(), "up": x[..., 8:].copy(),
                 "w": rng.randn(8, 9, 11, 5).astype(np.float32)},
                _head_params(rng, 24, 48, 5))
    if case == "up":
        return ({"x": rng.randn(8, 9, 9, 128).astype(np.float32),
                 "w": rng.randn(8, 33, 33, 128).astype(np.float32)}, {})
    if case == "loss_up":
        return ({"s": rng.randn(8, 5, 9, 9).astype(np.float32),
                 "t": rng.randn(8, 5, 9, 9).astype(np.float32),
                 "labels": _labels(rng, 8, 5, 33)}, {})
    if case == "loss_ce":
        return ({"s": rng.randn(8, 4, 5, 5).astype(np.float32),
                 "labels": _labels(rng, 8, 4, 17, void=0.0)}, {})
    if case == "loss_full":
        return ({"s": rng.randn(8, 5, 17, 17).astype(np.float32),
                 "t": rng.randn(8, 5, 17, 17).astype(np.float32),
                 "labels": _labels(rng, 8, 5, 17)}, {})
    raise KeyError(case)


WRAPPERS = ("stem", "stem_f0", "ir", "head", "up", "loss_up", "loss_ce",
            "loss_full")


# ---------------------------------------------------------------------------
# the port's side: one case on this process's rows (torch and the port only)
# ---------------------------------------------------------------------------

def _leaf(a):
    return torch.tensor(a).requires_grad_()


def _run_case(case, batch, params, group, sharded=True):
    """The port's wrapper on `batch` (this rank's rows) under `group`.
    Returns {name: tensor}: outputs (rows), global moments, this rank's
    part of the objective sum(out * w) or the global loss, the input's
    gradient (rows) and the parameters' (this rank's share). sharded=False
    calls the unsharded function (no group argument)."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import irchain as tir
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf
    from kd_cheap_conv_tpu_torch.ops import stem as tst
    from kd_cheap_conv_tpu_torch.ops import upsample as tup

    b = {k: torch.tensor(v) for k, v in batch.items()}
    p = {k: _leaf(v) for k, v in params.items()}
    if "w0" in p:
        p["w0"] = p["w0"].detach().permute(3, 2, 0, 1).contiguous() \
            .requires_grad_()                          # HWIO -> OIHW
    res = {}
    if case in ("stem", "stem_f0", "ir", "head", "up"):
        x = b["x"].requires_grad_() if "x" in b else None
        if case.startswith("stem"):
            fn = (tst.fused_stem_f1f2_sharded if sharded
                  else tst.fused_stem_f1f2)
            args = (x, p, group, EPS) if sharded else (x, p, EPS)
            out, stats = fn(*args)
            outs, ws = [out], [b["w"]]
        elif case == "ir":
            fn = tir.fused_ir_chain_sharded if sharded else tir.fused_ir_chain
            args = (x, p, group, EPS) if sharded else (x, p, EPS)
            out, low, stats = fn(*args)
            outs, ws = [out, low], [b["w"], b["w_low"]]
        elif case == "head":
            low, up = b["low"].requires_grad_(), b["up"].requires_grad_()
            if sharded:
                y, stats = tdec.fused_decoder_head_sharded(low, up, p, group,
                                                           EPS)
            else:
                y, stats = tdec.fused_decoder_head(low, up, p, EPS)
            stats = [stats]
            outs, ws = [y], [b["w"]]
        else:
            y = (tup.resize_bilinear_up_sharded(x, (33, 33), group)
                 if sharded else tup.resize_bilinear_up(x, (33, 33)))
            stats, outs, ws = [], [y], [b["w"]]
        part = sum((o * w).sum() for o, w in zip(outs, ws))
        part.backward()
        res.update({f"out{i}": o.detach() for i, o in enumerate(outs)})
        res.update({f"mean{i}": m for i, (m, _) in enumerate(stats)})
        res.update({f"var{i}": v for i, (_, v) in enumerate(stats)})
        res["part"] = part.detach()
        if case == "head":
            res["d_low"], res["d_up"] = low.grad, up.grad
        else:
            res["d_x"] = x.grad
    else:
        s = b["s"].requires_grad_()
        h, w = b["labels"].shape[1:]
        if case == "loss_ce":
            kw = {"group": group} if sharded else {}
            task = lf.fused_ce_loss_upsampled(s, b["labels"], h, w, 255, **kw)
            total, kd = task, torch.zeros(())
        elif case == "loss_up":
            args = (s, b["t"], b["labels"])
            tail = (h, w, 4.0, 0.5, 0.5, 255, 3e4)
            total, task, kd = (
                lf.fused_ce_kl_loss_upsampled_sharded(*args, group, *tail)
                if sharded else lf.fused_ce_kl_loss_upsampled(*args, *tail))
        else:
            args = (s, b["t"], b["labels"])
            tail = (4.0, 0.5, 0.5, 255, 3e4)
            total, task, kd = (
                lf.fused_ce_kl_loss_sharded(*args, group, *tail) if sharded
                else lf.fused_ce_kl_loss(*args, *tail))
        total.backward()
        res.update(total=total.detach(), task=task.detach(), kd=kd.detach(),
                   d_s=s.grad)
    res.update({f"d_{k}": v.grad for k, v in p.items()})
    return res


def _rows(batch, group):
    from kd_cheap_conv_tpu_torch.parallel import shard_batch

    keys = sorted(batch)
    return dict(zip(keys, shard_batch(tuple(batch[k] for k in keys), group)))


def _bn_blocks():
    """Per-rank constant blocks: rank r's rows all hold r (NCHW), so each
    rank's variance is 0 and the global one is 0.25."""
    x = np.repeat(np.arange(WORLD, dtype=np.float32), 4 * 4 * 4 * 4)
    w = np.random.RandomState(5).randn(8, 4, 4, 4).astype(np.float32)
    return x.reshape(8, 4, 4, 4), w


def _run_bn(x, w):
    """One train-mode BatchNorm (momentum None, so its running statistics
    become the batch's) on x NCHW channels_last: (y, running mean, running
    var, dx, dgamma, dbeta) under the active group."""
    from kd_cheap_conv_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(4, momentum=None)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 1.5, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
    bn.train()
    xt = torch.tensor(x).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = bn(xt)
    (y * torch.tensor(w)).sum().backward()
    return {"y": y.detach(), "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "dx": xt.grad,
            "dgamma": bn.weight.grad, "dbeta": bn.bias.grad}


KD_HW, KD_N, KD_CLS = 33, 4, 6
KD_DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _kd_batch():
    rng = np.random.RandomState(3)
    return (rng.randn(KD_N, 3, KD_HW, KD_HW).astype(np.float32),
            rng.randint(0, KD_CLS, (KD_N, KD_HW, KD_HW)).astype(np.int64))


def _run_kd_step(images, labels, dtype=torch.float32):
    """One config-#2-shaped KD step (MobileNetV2 student with the
    separable head, a MobileNetV2 teacher, dropout off, every BN's momentum
    None) on these rows in `dtype` (the models' parameters and the images),
    under the active group. Returns the loss, every BN's running
    statistics, every gradient (after the step's all-reduce) and every
    weight after SGD."""
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    g = torch.Generator().manual_seed(1)
    student = build_model("deeplabv3plus_mobilenet", KD_CLS, 16, generator=g)
    teacher = build_model("deeplabv3plus_mobilenet", KD_CLS, 16,
                          generator=torch.Generator().manual_seed(2))
    replace_cheap_convs(student, CheapConvSpec(), scope="classifier",
                        generator=g)
    student.classifier.aspp.dropout.p = 0.0
    for m in student.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    student = student.to(dtype=dtype, memory_format=torch.channels_last)
    teacher = teacher.to(dtype=dtype,
                         memory_format=torch.channels_last).eval()
    opt, sched = make_optimizer(student.named_parameters(), lr=0.01,
                                max_iters=100)
    step = make_kd_train_step(student, teacher, opt, KDConfig(), sched)
    x = torch.tensor(images, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    metrics = step(x, torch.tensor(labels))
    res = {"loss": metrics["loss"]}
    for k, m in student.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            res[f"rm.{k}"] = m.running_mean.clone()
            res[f"rv.{k}"] = m.running_var.clone()
    for k, p in student.named_parameters():
        res[f"grad.{k}"] = p.grad.clone()
        res[f"w.{k}"] = p.detach().clone()
    return res


def _collectives_banned():
    """torch.distributed.all_reduce made to raise, as a context."""
    import torch.distributed as dist

    def boom(*args, **kwargs):
        raise AssertionError("a collective was called at world size 1")

    @contextlib.contextmanager
    def ctx():
        orig = dist.all_reduce
        dist.all_reduce = boom
        try:
            yield
        finally:
            dist.all_reduce = orig

    return ctx()


def _same(a, b):
    return set(a) == set(b) and all(
        (a[k] is None and b[k] is None)
        or (a[k] is not None and b[k] is not None and torch.equal(a[k], b[k]))
        for k in a)


def _world_one(rank_group):
    """Rank 0's checks at world size 1: each wrapper, the BN and the KD
    step under a group of one rank (and with None) against the unsharded
    functions, bit for bit, with all_reduce raising. Returns {case: ok}."""
    from kd_cheap_conv_tpu_torch.parallel import set_active_group

    ok = {}
    with _collectives_banned():
        for case in WRAPPERS:
            batch, params = _case_data(case)
            want = _run_case(case, batch, params, None, sharded=False)
            ok[case] = all(_same(_run_case(case, batch, params, grp), want)
                           for grp in (rank_group, None))
        x, w = _bn_blocks()
        want = _run_bn(x, w)
        set_active_group(rank_group)
        try:
            ok["bn"] = _same(_run_bn(x, w), want)
            got = _run_kd_step(*_kd_batch())
        finally:
            set_active_group(None)
        ok["kd_step"] = _same(got, _run_kd_step(*_kd_batch()))
    return ok


def _rank_main(rank, world, tmp):
    """One rank: join the gloo group through a FileStore, run every case on
    this rank's rows, write the results to tmp/rank{r}.pt."""
    import torch.distributed as dist

    from kd_cheap_conv_tpu_torch.parallel import (init_distributed,
                                                  set_active_group,
                                                  shard_batch, shutdown)

    torch.set_num_threads(2)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    group = init_distributed(None, world, rank, device="cpu",
                             timeout_s=TIMEOUT_S, store=store)
    try:
        out = {}
        for case in WRAPPERS:
            batch, params = _case_data(case)
            out[case] = _run_case(case, _rows(batch, group), params, group)
        # the upsample is per image: each rank's call equals the unsharded
        # one on its rows
        rows = _rows(_case_data("up")[0], group)
        out["up_local"] = _run_case("up", rows, {}, None, sharded=False)
        x, w = _bn_blocks()
        xr, wr = shard_batch((x, w), group)
        out["bn"] = _run_bn(xr, wr)
        images, labels = _kd_batch()
        out["kd_step"] = {
            name: _run_kd_step(*shard_batch((images, labels), group), dt)
            for name, dt in KD_DTYPES.items()}
        set_active_group(None)
        try:
            shard_batch((np.zeros((3, 2)),), group)
            out["odd_batch_raised"] = False
        except ValueError:
            out["odd_batch_raised"] = True
        singles = [dist.new_group([r]) for r in range(world)]
        out["world_one"] = (_world_one(singles[rank]) if rank == 0
                            else None)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        shutdown()


def _spawn(target, tmp, world=WORLD, meanwhile=None):
    """Run target(rank, world, tmp) in `world` spawned processes, and
    `meanwhile()` in this one while they run; join them with a timeout.
    Fails if one is still alive; returns their exit codes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.is_alive() for p in procs]
        for p, a in zip(procs, alive):
            if a:
                p.kill()
                p.join(10)
    assert not any(alive), "a rank did not finish in time"
    return [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")

    def jax_references():
        for case in WRAPPERS:
            _jax_case(case)

    codes = _spawn(_rank_main, tmp, meanwhile=jax_references)
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the JAX side: the *_sharded functions on a 2-device mesh, interpret mode
# ---------------------------------------------------------------------------

def _w0_param(w):
    """HWIO entry kernel -> the JAX hcat-packed f0 param."""
    import jax.numpy as jnp

    co = w.shape[3]
    w2 = jnp.pad(w, ((0, 1), (0, 1), (0, 0), (0, 0)))
    w2 = jnp.transpose(w2.reshape(2, 2, 2, 2, 3, co),
                       (0, 2, 1, 3, 4, 5)).reshape(4, 12, co)
    return jnp.transpose(w2, (2, 0, 1)).reshape(co, 48)


@functools.cache
def _jax_case(case):
    """The JAX *_sharded function on the global batch: {name: numpy} in the
    port's names and layouts (the objective's value under 'part' / the
    losses, gradients of the input and the params)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kd_cheap_conv_tpu.ops.conv import s2d_pack
    from kd_cheap_conv_tpu.ops.pallas import decoder as jdec
    from kd_cheap_conv_tpu.ops.pallas import irchain as jir
    from kd_cheap_conv_tpu.ops.pallas import losses as jl
    from kd_cheap_conv_tpu.ops.pallas import stem as jst
    from kd_cheap_conv_tpu.ops.pallas import upsample as jup
    from kd_cheap_conv_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices()[:WORLD])
    spec = NamedSharding(mesh, P("data"))
    batch, params = _case_data(case)
    b = {k: jax.device_put(jnp.asarray(v), spec) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    res = {}

    def grads(f, args, names):
        (val, aux), g = jax.jit(jax.value_and_grad(
            f, argnums=tuple(range(len(args))), has_aux=True))(*args)
        for name, gi in zip(names, g):
            if isinstance(gi, dict):
                res.update({f"d_{k}": np.asarray(v) for k, v in gi.items()})
            else:
                res[name] = np.asarray(gi)
        return val, aux

    if case.startswith("stem"):
        def f(x, p):
            if case == "stem_f0":
                inp = s2d_pack(x, channel_sublane=True)
                p = {**p, "w0": _w0_param(p["w0"])}
            else:
                inp = jnp.transpose(x, (0, 1, 3, 2))
            out, stats = jst.fused_stem_f1f2_sharded(inp, p, mesh, EPS, True)
            return jnp.sum(out * b["w"]), (out, stats)

        val, (out, stats) = grads(f, (b["x"], jp), ("d_x", "p"))
        outs = [out]
        if case == "stem_f0":
            res["d_w0"] = np.transpose(res["d_w0"], (3, 2, 0, 1))
    elif case == "ir":
        def f(x, p):
            out, low, stats = jir.fused_ir_chain_sharded(x, p, mesh, EPS,
                                                         True)
            return (jnp.sum(out * b["w"]) + jnp.sum(low * b["w_low"]),
                    (out, low, stats))

        val, (out, low, stats) = grads(f, (b["x"], jp), ("d_x", "p"))
        outs = [out, low]
    elif case == "head":
        def f(low, up, p):
            y, st = jdec.fused_decoder_head_folded_sharded(low, up, p, mesh,
                                                           EPS, True)
            return jnp.sum(y * b["w"]), (y, st)

        val, (y, st) = grads(f, (b["low"], b["up"], jp),
                             ("d_low", "d_up", "p"))
        outs, stats = [y], [st]
    elif case == "up":
        def f(x):
            y = jup.resize_bilinear_up_sharded(x, (33, 33), mesh, True)
            return jnp.sum(y * b["w"]), y

        val, y = grads(f, (b["x"],), ("d_x",))
        outs, stats = [y], []
    else:
        lbl = b["labels"].astype(jnp.int32)
        h, w = batch["labels"].shape[1:]

        def f(s):
            if case == "loss_ce":
                task = jl.fused_ce_loss_upsampled(s, lbl, h, w, 255, True,
                                                  mesh=mesh)
                return task, (task, jnp.zeros(()))
            if case == "loss_up":
                total, task, kd = jl.fused_ce_kl_loss_upsampled_sharded(
                    s, b["t"], lbl, mesh, h, w, 4.0, 0.5, 0.5, 255, 3e4,
                    True)
            else:
                total, task, kd = jl.fused_ce_kl_loss_sharded(
                    s, b["t"], lbl, mesh, 4.0, 0.5, 0.5, 255, 3e4, True)
            return total, (task, kd)

        total, (task, kd) = grads(f, (b["s"],), ("d_s",))
        res.update(total=float(total), task=float(task), kd=float(kd))
        return res
    res["part"] = float(val)
    res.update({f"out{i}": np.asarray(o) for i, o in enumerate(outs)})
    for i, (m, v) in enumerate(stats):
        res[f"mean{i}"], res[f"var{i}"] = np.asarray(m), np.asarray(v)
    return res


def _joined(ranks, case, key):
    return np.concatenate([r[case][key].numpy() for r in ranks])


def _summed(ranks, case, key):
    return sum(r[case][key].double() for r in ranks).numpy()


@pytest.mark.parametrize("case", WRAPPERS)
def test_wrapper_matches_jax_sharded(ranks, case):
    """Each ported wrapper on 2 ranks against the JAX *_sharded function on
    a 2-device mesh: forward values, global moments (equal on both ranks),
    the objective, the input's gradient and the parameters'."""
    want = _jax_case(case)
    r0, r1 = ranks[0][case], ranks[1][case]
    if case.startswith("loss"):
        for k in ("total", "task", "kd"):
            assert float(r0[k]) == float(r1[k]), k
            np.testing.assert_allclose(float(r0[k]), want[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(_joined(ranks, case, "d_s"), want["d_s"],
                                   **LOSS_G)
        return
    stem_like = case in ("stem", "stem_f0", "ir")
    np.testing.assert_allclose(float(r0["part"] + r1["part"]), want["part"],
                               rtol=1e-4 if stem_like else 1e-5)
    n_out = sum(k.startswith("out") for k in want)
    for i in range(n_out):
        np.testing.assert_allclose(_joined(ranks, case, f"out{i}"),
                                   want[f"out{i}"], err_msg=f"out{i}", **VAL)
    moments = [k for k in want if k.startswith(("mean", "var"))]
    assert len(moments) == sum(k.startswith(("mean", "var")) for k in r0)
    for k in moments:
        assert torch.equal(r0[k], r1[k]), k
        np.testing.assert_allclose(r0[k].numpy(), want[k], err_msg=k, **SUM)
    for k in ("d_x", "d_low", "d_up"):
        if k in want:
            np.testing.assert_allclose(_joined(ranks, case, k), want[k],
                                       err_msg=k, **DX)
    params = [k for k in want if k.startswith("d_") and k[2:] in
              _case_data(case)[1]]
    assert len(params) == len(_case_data(case)[1])
    for k in params:
        np.testing.assert_allclose(_summed(ranks, case, k), want[k],
                                   err_msg=k, **DP)


def test_upsample_rank_is_bit_identical_to_the_unsharded_call(ranks):
    for r in ranks:
        for k in ("out0", "d_x"):
            assert torch.equal(r["up"][k], r["up_local"][k]), k


def test_batchnorm_uses_global_moments(ranks):
    """Constant per-rank blocks: a per-rank BN would give all zeros; the
    sync-BN gives the one-process output, gradients, and a running variance
    equal to the global biased variance, 0.25."""
    x, w = _bn_blocks()
    want = _run_bn(x, w)
    got = {k: torch.cat([r["bn"][k] for r in ranks])
           for k in ("y", "dx")}
    assert float(got["y"].abs().max()) > 0.5, "per-rank BN (all-zero out)"
    for k in ("y", "dx"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("dgamma", "dbeta"):
        np.testing.assert_allclose(_summed(ranks, "bn", k), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["running_var"].numpy(),
                                   np.full(4, 0.25), rtol=1e-6)
        np.testing.assert_allclose(r["bn"]["running_mean"].numpy(),
                                   np.full(4, 0.5), rtol=1e-6)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r["bn"][k].numpy(), want[k].numpy(),
                                       rtol=1e-6, err_msg=k)


def _close(got, want, rel):
    """|got - want| <= rel * max(1, max |want|) elementwise: a scale for the
    quantities whose exact value is 0 (a BN bias followed by a linear conv
    and a train-mode BN, the running mean of a BN fed by such a BN)."""
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("dtype", list(KD_DTYPES))
def test_kd_step_matches_one_process(ranks, dtype):
    """One tiny KD step, 2 ranks x 2 images at 33², against the port's
    one-process step on the 4 images: the loss, every BN's running
    statistics (momentum None: the batch moments) and, in f64, every
    gradient after the step's SUM all-reduce and every weight after SGD;
    both ranks hold the same gradients and weights, bit for bit.

    f64 runs every chain, the decoder head and the loss through their
    plain versions (all but the upsample, which f64 leaves to
    F.interpolate) and holds the algorithm to 1e-9. f32 also runs the
    upsample; at 4 images of 33² one relu6 mask flipped at a BN's output by
    an f32 rounding moves a gradient by ~1e-3 of its norm in either run,
    so f32 gradients are held on the card at full size instead
    (chip_smoke.py ddp_parity, against f64)."""
    want = _run_kd_step(*_kd_batch(), KD_DTYPES[dtype])
    r0, r1 = ranks[0]["kd_step"][dtype], ranks[1]["kd_step"][dtype]
    assert set(r0) == set(want)
    assert float(r0["loss"]) == float(r1["loss"])
    np.testing.assert_allclose(float(r0["loss"]), float(want["loss"]),
                               rtol=1e-12 if dtype == "f64" else 1e-5)
    stats = [k for k in want if k.startswith(("rm.", "rv."))]
    # 59 BNs: the stem's 6, the IR chain's 12, the module path's (the
    # backbone's 34 and the head's 6: ASPP and the low-level projection)
    # and the fused decoder head's
    assert len(stats) == 2 * 59
    for k in ("backbone.features.0.bn", "backbone.features.6.pw_bn",
              "backbone.features.7.body.0.bn", "classifier.aspp.project.bn",
              "classifier.project.bn", "classifier.fuse.bn"):
        assert f"rm.{k}" in stats, k
    for k in want:
        if k.startswith(("grad.", "w.", "rm.", "rv.")):
            assert torch.equal(r0[k], r1[k]), k
    if dtype == "f32":
        # a mean is held in units of its channel's std: the f32 noise the
        # network carries to a near-zero mean (thread counts and batch sizes
        # reorder the CPU's sums) is ~1e-5 of a unit-scale activation, a
        # per-rank mean would be off by ~1 std
        rtol, atol = SUM["rtol"], SUM["atol"]
        for k in stats:
            tol = atol + rtol * (want[k].abs() if k.startswith("rv.")
                                 else want["rv." + k[3:]].sqrt())
            excess = (r0[k] - want[k]).abs() - tol
            assert float(excess.max()) <= 0, (k, float(excess.max()))
        return
    for k in want:
        if k.startswith(("grad.", "w.")):
            _close(r0[k], want[k], 1e-9)
        elif k != "loss":
            # BatchNorm moves its running statistics by the f32 batch
            # moments (as the JAX package keeps them), whatever the dtype
            _close(r0[k], want[k], 1e-6)


@pytest.mark.parametrize("case", (*WRAPPERS, "bn", "kd_step"))
def test_world_size_one_calls_no_collective(ranks, case):
    assert ranks[0]["world_one"][case]


def test_shard_batch_refuses_a_batch_that_does_not_divide(ranks):
    assert all(r["odd_batch_raised"] for r in ranks)


def _dead_rank_main(rank, world, tmp):
    """Rank 1 leaves right after joining; rank 0's all-reduce must raise
    (within the group's timeout), and it records that it did."""
    import torch.distributed as dist

    from kd_cheap_conv_tpu_torch.parallel import (all_reduce_sum,
                                                  init_distributed)

    store = dist.FileStore(os.path.join(tmp, "store"), world)
    group = init_distributed(None, world, rank, timeout_s=10.0, store=store)
    if rank == 1:
        os._exit(0)
    try:
        all_reduce_sum(torch.ones(4), group)
        Path(tmp, "raised").write_text("no")
    except RuntimeError as e:
        Path(tmp, "raised").write_text(f"yes: {e}")
    os._exit(0)


def test_dead_rank_makes_the_collective_raise(tmp_path):
    _spawn(_dead_rank_main, tmp_path)
    assert (tmp_path / "raised").read_text().startswith("yes")


# ---------------------------------------------------------------------------
# main.py under ranks
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


MAIN_ARGS = ["--kd", "--device", "cpu", "--crop_size", "33", "--batch_size",
             "4", "--val_batch_size", "8", "--total_itrs", "2",
             "--val_interval", "2", "--print_interval", "1", "--num_classes",
             "6", "--teacher_model", "deeplabv3plus_mobilenet",
             "--replace_scope", "classifier", "--num_workers", "2"]


def test_main_two_ranks_print_the_same_losses(tmp_path):
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kd_cheap_conv_tpu_torch.main", *MAIN_ARGS,
         "--ckpt_dir", str(tmp_path / f"ck{r}"), "--multihost",
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
         str(WORLD), "--process_id", str(r)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    losses = [[ln.split(" (")[0] for ln in text.splitlines()
               if ln.startswith("Itrs")] for text in outs]
    assert len(losses[0]) == 2 and losses[0] == losses[1], outs
    assert "backend gloo" in outs[0] and "Best Mean IoU" in outs[0]
    assert "Best Mean IoU" not in outs[1]
    # rank 0 alone writes the checkpoints
    assert sorted(os.listdir(tmp_path / "ck0")) == [
        "best_deeplabv3plus_mobilenet_synthetic_os16.pth",
        "latest_deeplabv3plus_mobilenet_synthetic_os16.pth"]
    assert not (tmp_path / "ck1").exists()


@pytest.mark.parametrize("extra, error", [
    (["--batch_size", "3"], ValueError),
    (["--model", "deeplabv3plus_xception"], NotImplementedError)])
def test_main_refuses_before_joining(extra, error):
    """Refused before the rank joins the group (so no peer is awaited): a
    global batch that does not divide over the ranks, an Xception model
    trained under more than one rank."""
    from kd_cheap_conv_tpu_torch import main as port_main

    with pytest.raises(error):
        port_main.main([*MAIN_ARGS, *extra, "--multihost",
                        "--coordinator_address", "127.0.0.1:1",
                        "--num_processes", "2", "--process_id", "0"])
