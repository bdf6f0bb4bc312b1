"""The port's int8 quantization (``repro_torch.quant``) and quant artifact
(``repro_torch.ckpt.checkpoint``) against the reference's, on numpy-seeded
inputs:

* layout: channel scales, codes, dequantized values and the quantized
  tile-CSR consts bit for bit; the modeled decode bytes equal;
* calibrate, per linear and per model tree (the reference's tiny GQA
  config, layer-stacked): codes, ``qscale``, ``rows_q`` and ``cols_q`` bit
  for bit; the folded ``scale·B'·A'`` within 1e-5 of the reference's
  (relative to its largest entry; f32), compared as a product because an
  SVD's singular pairs are unique only up to sign; ``max_abs_err`` within
  1e-6; the fold lowers the error and no code is −128;
* the artifact: the reference's export loads in the port and the port's
  in the reference, every leaf and dtype bit for bit; a foreign format is
  refused;
* the CLIs: a port ``Trainer`` checkpoint, calibrated by the port's
  ``python -m repro_torch.quant.calibrate`` and by the reference's, gives
  the same codes and scales, and the port's launcher serves the port's
  artifact in exec_mode quant (and the seeded init with
  ``--sparse-decode``) on the CPU.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ParamConfig as JParamConfig
from repro.core import support as jsupport
from repro.models import registry as jregistry
from repro.quant import calibrate as jcalibrate
from repro.quant import layout as jlayout
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.quant import calibrate, layout

FOLD_RTOL = 1e-5
ERR_ATOL = 1e-6


def _coo(d_in, d_out, delta, seed):
    rows, cols = jsupport.sample_support(seed, d_in, d_out, delta)
    rng = np.random.default_rng(seed)
    return rows, cols, rng


def _np(a):
    """numpy of a jax array or a torch tensor; bf16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 99.0])
@pytest.mark.parametrize("shape", [(128, 128, 0.03), (130, 250, 0.05),
                                   (384, 128, 0.05)])
def test_layout_matches_reference_bit_for_bit(shape, clip):
    d_in, d_out, delta = shape
    rows, cols, rng = _coo(d_in, d_out, delta, seed=d_in + d_out)
    W = rng.standard_normal((d_in, d_out)).astype(np.float32)
    W[:, 3] = 0.0                                   # an all-zero channel
    v = W[rows, cols]
    sc = layout.channel_scales(W, clip_percentile=clip)
    _same(sc, jlayout.channel_scales(W, clip_percentile=clip), "scales")
    qv = layout.quantize_values(v, cols, sc)
    _same(qv, jlayout.quantize_values(v, cols, sc), "codes")
    assert qv.min() >= -127
    _same(layout.dequantize_values(qv, cols, sc),
          jlayout.dequantize_values(qv, cols, sc), "dequantized")
    got = layout.build_quant_consts(rows, cols, qv, sc, d_in, d_out, delta,
                                    "row_balanced")
    want = jlayout.build_quant_consts(rows, cols, qv, sc, d_in, d_out,
                                      delta, "row_balanced")
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("shape", [(2048, 2048, 0.03), (2048, 5461, 0.03),
                                   (5461, 2048, 0.03), (130, 250, 0.05)])
@pytest.mark.parametrize("kind", ["row_balanced", "iid"])
def test_sparse_decode_bytes_match_reference(shape, kind):
    for quant in (False, True):
        assert layout.sparse_decode_bytes(*shape, kind, quant=quant) == \
            jlayout.sparse_decode_bytes(*shape, kind, quant=quant)


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

def _check_fold(B2, A2, jB2, jA2, scale):
    got = scale * (B2.float().numpy().astype(np.float64)
                   @ A2.float().numpy().astype(np.float64))
    want = scale * (np.asarray(jB2, np.float64) @ np.asarray(jA2,
                                                             np.float64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FOLD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(256, 384, 16, 0.05), (130, 250, 8, 0.05),
                                   (384, 128, 8, 0.05)])
def test_quantize_linear_matches_reference(shape):
    d_in, d_out, r, delta = shape
    rows, cols, rng = _coo(d_in, d_out, delta, seed=d_in * 3 + d_out)
    k = rows.shape[0] // d_in
    B = (rng.standard_normal((d_in, r)) * 0.05).astype(np.float32)
    A = (rng.standard_normal((r, d_out)) * 0.05).astype(np.float32)
    v = (rng.standard_normal((d_in, k)) * 0.05).astype(np.float32)
    c = cols.reshape(d_in, k)
    jp = {"B": jnp.asarray(B), "A": jnp.asarray(A), "v": jnp.asarray(v)}
    tp = {"B": torch.from_numpy(B), "A": torch.from_numpy(A),
          "v": torch.from_numpy(v)}
    errs = {}
    for fold in (False, True):
        kw = dict(alpha=16.0, delta=delta, support_kind="row_balanced",
                  fold_error=fold)
        jnp_, jqc, jst = jcalibrate.quantize_linear(
            jp, {"cols": jnp.asarray(c)}, **kw)
        np_, qc, st = calibrate.quantize_linear(
            tp, {"cols": torch.from_numpy(c)}, **kw)
        for key in jqc:
            _same(qc[key], jqc[key], key)
        assert st["nnz"] == jst["nnz"]
        assert abs(st["max_abs_err"] - jst["max_abs_err"]) <= ERR_ATOL
        assert abs(st["rms_err"] - jst["rms_err"]) <= ERR_ATOL
        assert np_["B"].dtype == torch.float32 and np_["v"] is tp["v"]
        _check_fold(np_["B"], np_["A"], jnp_["B"], jnp_["A"], 16.0 / r)
        if not fold:
            _same(np_["B"], B, "B unchanged without the fold")
        assert int(qc["qv_t"].min()) >= -127
        errs[fold] = st["max_abs_err"]
    assert errs[True] < errs[False]


def _tiny(n_kv_heads, dtype):
    return JModelConfig(
        name=f"quant-gqa{n_kv_heads}", family="llama", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=n_kv_heads, d_ff=160,
        vocab_size=256, vocab_pad_multiple=16, max_seq_len=64, dtype=dtype,
        param=JParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=16.0))


def _reference_tree(n_kv_heads, dtype="float32"):
    """The reference's config and init, with B drawn U(−1, 1)."""
    cfg = _tiny(n_kv_heads, dtype)
    params, consts = jregistry.get_api(cfg).init(cfg, jax.random.PRNGKey(0),
                                                 seed=0)
    rng = np.random.default_rng(1)

    def fill_b(path, leaf):
        if str(path[-1].key) == "B":
            return jnp.asarray(rng.uniform(-1, 1, leaf.shape), leaf.dtype)
        return leaf

    return cfg, jax.tree_util.tree_map_with_path(fill_b, params), consts


def _flat(tree):
    return dict(tree_leaves(tree))


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_calibrate_tree_matches_reference(n_kv):
    cfg, params, consts = _reference_tree(n_kv)
    jqp, jqc, jst = jcalibrate.calibrate_model(cfg, params, consts)
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, consts), device="cpu")
    qp, qc, st = calibrate.calibrate_tree(tp, tc, alpha=16.0, delta=0.05)
    assert st["n_matrices"] == jst["n_matrices"] == 14
    assert st["nnz"] == jst["nnz"] and st["format"] == jst["format"]
    assert abs(st["max_abs_err"] - jst["max_abs_err"]) <= ERR_ATOL
    got_c, want_c = _flat(qc), _jflat(jqc)
    assert set(got_c) == set(want_c)
    for key in want_c:
        _same(got_c[key], want_c[key], key)
    got_p, want_p = _flat(qp), _jflat(jqp)
    assert set(got_p) == set(want_p)
    for key, want in want_p.items():
        got = got_p[key]
        if key.endswith("/B") or key.endswith("/A"):
            assert got.dtype == torch.float32 and \
                tuple(got.shape) == want.shape
        else:
            _same(got, want, key)          # embeddings, norms, v
    for key in want_p:
        if key.endswith("/B"):
            a = key[:-1] + "A"
            r = want_p[key].shape[-1]
            for i in range(want_p[key].shape[0]):    # per stacked layer
                _check_fold(got_p[key][i], got_p[a][i], want_p[key][i],
                            want_p[a][i], 16.0 / r)
    assert min(int(t.min()) for k, t in got_c.items()
               if k.endswith("qv_t")) >= -127


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def test_artifact_loads_across_packages_bit_for_bit(tmp_path):
    """bf16 params (bit-views), int8 codes, int16 indices, f32 scales and
    int32 supports travel both ways unchanged."""
    cfg, params, consts = _reference_tree(2, dtype="bfloat16")
    jqp, jqc, jst = jcalibrate.calibrate_model(cfg, params, consts)
    ref_dir = str(tmp_path / "from_reference")
    jckpt.save_quant_artifact(ref_dir, jqp, jqc, config_hash="h",
                              extra=jst)
    tp, tc, man = ckpt.load_quant_artifact(ref_dir, device="cpu")
    assert man["format"] == ckpt.QUANT_FORMAT == jckpt.QUANT_FORMAT
    assert man["extra"]["n_matrices"] == jst["n_matrices"]
    dtypes = set()
    for got, want in ((tp, jqp), (tc, jqc)):
        got, want = _flat(got), _jflat(want)
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key], key)
            dtypes.add(str(got[key].dtype))
    assert {"torch.bfloat16", "torch.int8", "torch.int16", "torch.float32",
            "torch.int32"} <= dtypes

    port_dir = str(tmp_path / "from_port")
    ckpt.save_quant_artifact(port_dir, tp, tc, config_hash="h",
                             extra=man["extra"])
    rp, rc, rman = jckpt.load_quant_artifact(port_dir)
    assert rman["extra"] == man["extra"]
    for got, want in ((rp, tp), (rc, tc)):
        got, want = _jflat(got), _flat(want)
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key], key)

    mpath = tmp_path / "from_port" / "manifest.json"
    bad = json.loads(mpath.read_text())
    bad["format"] = "sltrain-quant-v0"
    mpath.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="format"):
        ckpt.load_quant_artifact(port_dir, device="cpu")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


def test_calibrate_cli_and_quant_launcher_on_cpu(tmp_path):
    from repro_torch.launch import serve, train
    ck = str(tmp_path / "train")
    train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "8",
                "--device", "cpu", "--ckpt-dir", ck])
    art = str(tmp_path / "artifact")
    out = _run(calibrate.main, ["--arch", "llama_60m", "--smoke",
                                "--ckpt-dir", ck, "--out", art, "--device",
                                "cpu"])
    assert out.startswith("quant artifact: 14 matrices")
    # the reference's calibrator reads the same checkpoint: same codes
    jart = str(tmp_path / "artifact_ref")
    _run(jcalibrate.main, ["--arch", "llama_60m", "--smoke", "--ckpt-dir",
                           ck, "--out", jart])
    _, tc, man = ckpt.load_quant_artifact(art, device="cpu")
    _, jc, jman = jckpt.load_quant_artifact(jart)
    assert man["config_hash"] == jman["config_hash"]
    got, want = _flat(tc), _jflat(jc)
    assert set(got) == set(want)
    for key in want:
        _same(got[key], want[key], key)

    base = ["--arch", "llama_60m", "--smoke", "--paged", "--requests", "2",
            "--slots", "2", "--max-len", "32", "--new-tokens", "3",
            "--device", "cpu"]
    out = _run(serve.main, base + ["--exec-mode", "quant", "--quant-ckpt",
                                   art])
    assert f"quant artifact: {art} (14 matrices)" in out
    assert "served 2 requests, 6 tokens" in out and "exec_mode=quant" in out
    out = _run(serve.main, base + ["--sparse-decode"])
    assert "served 2 requests, 6 tokens" in out and "exec_mode=sparse" in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--sparse-decode", "--exec-mode", "sparse"])
    with pytest.raises(ValueError, match="needs calibrated consts"):
        serve.main(base + ["--exec-mode", "quant"])

