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
import dataclasses
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

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

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


def test_perlayer_8bit_fused_checkpoint_calibrates_and_serves(tmp_path):
    """The launchers in the order of the 7B memory path's round trip:
    per-layer 8-bit AdamW in exec_mode fused, the calibrate CLI on its
    checkpoint (the reference's calibrator gives the same codes), then
    the quant engine. On the CPU no launcher prints a device peak."""
    from repro_torch.launch import serve, train
    ck = str(tmp_path / "train")
    out = _run(train.main, ["--smoke", "--steps", "1", "--batch", "2",
                            "--seq", "8", "--update-mode", "per_layer",
                            "--optimizer", "adam8bit", "--exec-mode",
                            "fused", "--device", "cpu", "--ckpt-dir", ck])
    art = str(tmp_path / "artifact")
    out += _run(calibrate.main, ["--arch", "llama_60m", "--smoke",
                                 "--ckpt-dir", ck, "--out", art, "--device",
                                 "cpu"])
    assert "quant artifact: 14 matrices" in out
    jart = str(tmp_path / "artifact_ref")
    _run(jcalibrate.main, ["--arch", "llama_60m", "--smoke", "--ckpt-dir",
                           ck, "--out", jart])
    _, tc, _ = ckpt.load_quant_artifact(art, device="cpu")
    _, jc, _ = jckpt.load_quant_artifact(jart)
    got, want = _flat(tc), _jflat(jc)
    assert set(got) == set(want)
    for key in want:
        _same(got[key], want[key], key)
    out += _run(serve.main, ["--arch", "llama_60m", "--smoke", "--paged",
                             "--requests", "2", "--slots", "2", "--max-len",
                             "32", "--new-tokens", "3", "--device", "cpu",
                             "--exec-mode", "quant", "--quant-ckpt", art])
    assert "served 2 requests, 6 tokens" in out and "exec_mode=quant" in out
    assert "peak device memory" not in out



# ---------------------------------------------------------------------------
# quant_fallback, --ckpt-dir and the quant recipe (llama_60m smoke)
# ---------------------------------------------------------------------------

def _smoke(exec_mode=None):
    from repro_torch.analysis.quant_recipe import with_exec_mode
    from repro_torch.models import registry
    j = jregistry.get_smoke_config("llama_60m")
    t = registry.get_smoke_config("llama_60m")
    if exec_mode is None:
        return j, t
    jmode = "dense" if exec_mode == "quant" else exec_mode
    return (dataclasses.replace(j, param=dataclasses.replace(
        j.param, exec_mode=jmode)), with_exec_mode(t, exec_mode))


def _serve_tokens(eng, prompts, new_tokens=4):
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.run_until_drained()
    assert all(r.status == "done" for r in reqs)
    return [r.out for r in reqs]


PROMPTS = [[5, 9, 11], [7, 3, 200, 31, 8], [400, 12]]
ENGINE = dict(n_slots=2, max_len=32, paged=True, block_len=8)


def test_quant_fallback_serves_the_sparse_path_as_the_reference(recwarn):
    """Without int8 consts a quant engine with ``quant_fallback`` serves
    through the sparse path: it warns, says so and counts it, and gives
    the tokens of the port's sparse engine and of the reference's own
    fallback engine on the same weights. Without the fallback, or without
    the sparse path's consts, it raises."""
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.serve.engine import ServeEngine
    jcfg, cfg = _smoke("fused")
    params, consts = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                                  seed=0)
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, consts), device="cpu")
    with pytest.warns(UserWarning, match="degraded"):
        jeng = JaxEngine(jcfg, params, consts, exec_mode="quant",
                         quant_fallback=True, **ENGINE)
    with pytest.warns(UserWarning, match="degraded"):
        eng = ServeEngine(cfg, tp, tc, exec_mode="quant",
                          quant_fallback=True, device="cpu", **ENGINE)
    assert eng.quant_fell_back and jeng.quant_fell_back
    assert eng.cfg.param.exec_mode == "sparse"
    assert eng.obs.snapshot()["serve.quant_fallback"]["value"] == 1
    sparse = ServeEngine(cfg, tp, tc, exec_mode="sparse", device="cpu",
                         **ENGINE)
    assert not sparse.quant_fell_back
    assert sparse.obs.snapshot()["serve.quant_fallback"]["value"] == 0
    got = _serve_tokens(eng, PROMPTS)
    assert got == _serve_tokens(sparse, PROMPTS)
    assert got == _serve_tokens(jeng, PROMPTS)
    with pytest.raises(ValueError, match="needs calibrated consts"):
        ServeEngine(cfg, tp, tc, exec_mode="quant", device="cpu", **ENGINE)

    def drop_tiles(c):
        return {k: drop_tiles(v) if isinstance(v, dict) else v
                for k, v in c.items() if k not in ("rows_t", "cols_t",
                                                   "perm")}
    with pytest.raises(ValueError, match="needs calibrated consts"):
        ServeEngine(cfg, tp, drop_tiles(tc), exec_mode="quant",
                    quant_fallback=True, device="cpu", **ENGINE)


def _port_trainer_ckpt(path):
    from repro_torch.launch import train
    train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
                "--device", "cpu", "--ckpt-dir", path])


def _reference_ckpt(path):
    """A checkpoint the reference's CheckpointManager writes, of its init
    with B drawn U(−0.5, 0.5) (so the low-rank half serves)."""
    jcfg, _ = _smoke()
    params, _ = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(3),
                                             seed=3)
    rng = np.random.default_rng(5)

    def fill_b(p, leaf):
        if str(p[-1].key) == "B":
            return jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape), leaf.dtype)
        return leaf
    params = jax.tree_util.tree_map_with_path(fill_b, params)
    jckpt.CheckpointManager(path).save(7, {"params": params},
                                       config_hash=jcfg.hash())


@pytest.mark.parametrize("writer", ["port_trainer", "reference"])
def test_serve_ckpt_dir_gives_the_reference_engines_tokens(tmp_path, writer):
    """``launch.serve --ckpt-dir`` restores a training checkpoint of
    either package into the exec mode asked for (sparse here) and serves
    the reference engine's tokens on the same checkpoint; with exec_mode
    quant and ``--quant-fallback`` it serves the same tokens through the
    sparse path."""
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeEngine
    ck = str(tmp_path / "ckpt")
    (_port_trainer_ckpt if writer == "port_trainer" else _reference_ckpt)(ck)
    jcfg, cfg = _smoke("sparse")
    jp, jc = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0), seed=0)
    tree, _ = jckpt.CheckpointManager(ck).restore(
        {"params": jp}, allow_config_change=True)
    want = _serve_tokens(JaxEngine(jcfg, tree["params"], jc,
                                   sparse_decode=True, **ENGINE), PROMPTS)
    tp, tc = serve.load_model(cfg, device="cpu", ckpt_dir=ck)
    eng = ServeEngine(cfg, tp, tc, device="cpu", **ENGINE)
    assert eng.cfg.param.exec_mode == "sparse"
    assert _serve_tokens(eng, PROMPTS) == want
    _, qcfg = _smoke("quant")
    qp, qc = serve.load_model(qcfg, device="cpu", ckpt_dir=ck)
    with pytest.warns(UserWarning, match="degraded"):
        eng = ServeEngine(qcfg, qp, qc, quant_fallback=True, device="cpu",
                          **ENGINE)
    assert _serve_tokens(eng, PROMPTS) == want

    base = ["--arch", "llama_60m", "--smoke", "--paged", "--requests", "2",
            "--slots", "2", "--max-len", "32", "--new-tokens", "3",
            "--device", "cpu", "--ckpt-dir", ck]
    out = _run(serve.main, base + ["--exec-mode", "sparse"])
    assert f"checkpoint: {ck} (step" in out and "exec_mode=sparse" in out
    with pytest.warns(UserWarning, match="degraded"):
        out = _run(serve.main, base + ["--exec-mode", "quant",
                                       "--quant-fallback"])
    assert "quant fallback" in out and "exec_mode=sparse" in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--quant-ckpt", ck])


def test_quant_recipe_matches_reference_quant_rows(monkeypatch):
    """The recipe's rows from the reference-trained params (carried over
    through numpy) against the reference's ``quant_rows`` at smoke size
    with a few training steps and a short serving run (3 requests of 4
    new tokens): the same match rate, ppl within 1e-4 relative (the
    reference rounds ppl to 3 decimals, 5e-7 relative at these values),
    the same modeled bytes."""
    from benchmarks import quant_bench, tables
    from repro_torch.analysis import quant_recipe
    from repro_torch.models import registry
    steps, serve = 3, dict(requests=3, new_tokens=4)
    trained = []

    def keep(*a, **k):          # the params quant_rows trains
        trained.append(train(*a, **k))
        return trained[-1]
    train = tables._train
    monkeypatch.setattr(tables, "_train", keep)
    want = quant_bench.quant_rows(steps=steps, **serve)
    out, = trained
    _, cfg = _smoke("fused")
    _, consts = registry.get_api(cfg).init(cfg, seed=0, device="cpu")
    params, _ = from_jax_numpy(jax.tree.map(np.asarray, out["params"]), {},
                               device="cpu")
    qp, qc, qstats = calibrate.calibrate_model(cfg, params, consts)
    got = quant_recipe.quant_rows(cfg, params, consts, qp, qc, qstats,
                                  device="cpu", train_steps=steps, **serve)
    assert not quant_recipe.gate_failures(got)
    assert got[0]["matched_tokens"] == want[0]["matched_tokens"]
    for key in ("ppl_bf16", "ppl_int8"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-4)
    assert got[0]["quant_matrices"] == want[0]["quant_matrices"]
    for key in ("sparse_bytes_per_tok_bf16", "sparse_bytes_per_tok_int8"):
        assert got[1][key] == want[1][key]
