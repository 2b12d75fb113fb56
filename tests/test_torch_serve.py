"""The port's serving path against the JAX package's: plain prediction,
multi-scale + flip TTA, the eval step's confusion counts and `validate`, on
4 synthetic images at 33² (raw 0..255 pixels, as the synthetic --test_only
path feeds them), f32. Mean TTA probabilities agree within
rtol = atol = 1e-4; predictions may differ only where the JAX logits'
top-two gap is below 1e-3. Then the port's entry point end to end on the
CPU.
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from flax import nnx

from kd_cheap_conv_tpu.inference import make_predict_fn as jax_predict_fn
from kd_cheap_conv_tpu.inference import \
    make_tta_predict_fn as jax_tta_predict_fn
from kd_cheap_conv_tpu.train.loop import validate as jax_validate
from kd_cheap_conv_tpu.train.steps import make_eval_step as jax_eval_step
from kd_cheap_conv_tpu_torch import main as port_main
from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation
from kd_cheap_conv_tpu_torch.inference import (make_predict_fn,
                                               make_tta_predict_fn)
from kd_cheap_conv_tpu_torch.train.loop import validate
from kd_cheap_conv_tpu_torch.train.steps import make_eval_step
from test_torch_model import jax_forward, nchw, student_pair

torch.set_num_threads(1)

C = 6
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(n=4, size=33):
    ds = SyntheticSegmentation(C, size=size, length=n, seed=2)
    imgs, lbls = zip(*(ds[i] for i in range(n)))
    return (np.stack(imgs).astype(np.float32),
            np.stack(lbls).astype(np.int32))


def _assert_preds_match(got, want, logits_nhwc):
    top2 = np.sort(logits_nhwc, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < 1e-3
    differ = got != want
    assert not np.any(differ & ~near_tie), f"{differ.sum()} preds differ"


def test_predict_matches_jax():
    jm, tm = student_pair(C, 16)
    x, _ = _batch()
    want = np.asarray(jax_predict_fn(jm)(jnp.asarray(x)))
    got = make_predict_fn(tm)(nchw(x)).numpy()
    assert got.shape == (4, 33, 33)
    _assert_preds_match(got, want, jax_forward(jm, x))


def test_tta_matches_jax():
    jm, tm = student_pair(C, 16)
    x, _ = _batch()
    scales = (0.5, 0.75, 1.25)
    w_preds, w_probs = jax_tta_predict_fn(jm, scales=scales, flip=True)(
        jnp.asarray(x))
    g_preds, g_probs = make_tta_predict_fn(tm, scales=scales, flip=True)(
        nchw(x))
    w_probs = np.asarray(w_probs)
    np.testing.assert_allclose(g_probs.permute(0, 2, 3, 1).numpy(), w_probs,
                               **TOL)
    _assert_preds_match(g_preds.numpy(), np.asarray(w_preds), w_probs)


def test_eval_counts_and_validate_match_jax():
    jm, tm = student_pair(C, 16)
    x, y = _batch()
    y[0, :5, :5] = 255                            # void pixels stay out
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    w_counts, _ = jax_eval_step(graphdef, num_classes=C)(
        params, rest, (jnp.asarray(x), jnp.asarray(y)))
    g_counts, _ = make_eval_step(tm, num_classes=C)(nchw(x),
                                                    torch.from_numpy(y))
    assert g_counts.dtype == torch.int64
    np.testing.assert_array_equal(g_counts.numpy(), np.asarray(w_counts))
    assert int(g_counts.sum()) == int(((y >= 0) & (y < C)).sum())

    halves = [(x[:2], y[:2]), (x[2:], y[2:])]
    want = jax_validate(jm, [(jnp.asarray(a), jnp.asarray(b))
                             for a, b in halves], num_classes=C)
    got = validate(tm, [(nchw(a), torch.from_numpy(b)) for a, b in halves],
                   num_classes=C)
    for k in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_val_transform_matches_jax():
    from kd_cheap_conv_tpu.data.transforms import \
        val_transform as jax_val_transform
    from kd_cheap_conv_tpu_torch.data.transforms import val_transform

    img, lbl = SyntheticSegmentation(C, size=33, length=1, seed=2)[0]
    w_img, w_lbl = jax_val_transform()(img, lbl, np.random.default_rng(0))
    g_img, g_lbl = val_transform()(img, lbl, np.random.default_rng(0))
    assert g_img.dtype == np.float32 and g_lbl.dtype == np.int32
    np.testing.assert_allclose(g_img, w_img, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g_lbl, w_lbl)
    with pytest.raises(NotImplementedError):
        val_transform(33)


@pytest.mark.parametrize("extra,n_replaced", [
    ([], 4), (["--tta", "--tta_scales", "0.5,1.0"], 4),
    (["--output_stride", "8", "--cheap_conv", "grouped"], 4),
    # the head is separable already: nothing dense is left to replace
    (["--separable_conv"], 0)])
def test_main_end_to_end_on_cpu(extra, n_replaced):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main.main(["--test_only", "--dataset", "synthetic",
                             "--model", "deeplabv3plus_mobilenet", "--kd",
                             "--replace_scope", "classifier", "--device",
                             "cpu", "--crop_size", "33", "--num_classes",
                             str(C), "--val_batch_size", "8",
                             "--num_workers", "2", *extra])
    assert rc == 0
    text = out.getvalue()
    assert f"replaced {n_replaced} convs" in text
    miou = float(text.split("Mean IoU:")[1].split()[0])
    assert math.isfinite(miou) and 0.0 <= miou <= 1.0


def test_main_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--test_only", "--crop_size", "33"])
