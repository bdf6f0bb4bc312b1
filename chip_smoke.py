"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every hand-written kernel from the sources in the checkout,
holds each one against its plain PyTorch version at the serving path's
real shapes (with timings), then drives the paged serving engine on the
paper's ``llama_1b`` config at full width and depth with random weights
from a seed: once in float32 along two paths that must give the same
greedy tokens (fused ``sl_matmul`` + paged kernels, and dense densify +
gathered attention), and once in bfloat16, timed, with every kernel's
launch count read around the run. Any failure exits non-zero. Without a
CUDA device, or without the rest of the repository beside it, it exits
non-zero and prints no result.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# operations/s by input type, tensor cores for bf16, CUDA cores for f32.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the same inputs: |y - y_plain| <= atol +
# rtol * |y_plain|. The kernels keep the plain versions' rounding points,
# so only the order of f32 sums differs (and, in bf16, the one rounding
# of each W tile or output element that such an order can tip).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# a full L2 (50 MB) sweep before each timed launch: the serving path
# reads every weight once per step, so it finds them cold in L2
FLUSH_BYTES = 256 << 20

SL_SOURCE = "src/repro_torch/kernels/csrc/sl_matmul.cu"
PA_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {
    "sl_matmul": "src/repro/kernels/sl_matmul.py:63",
    "paged_attention": "src/repro/kernels/paged_attention.py:132",
    "paged_prefill": "src/repro/kernels/paged_attention.py:241",
}


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of one call, by CUDA events around each launch,
    with the L2 cache swept before every launch."""

    def __init__(self, device):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def ms(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, ops: float, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for the input type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, got, want, dtype):
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        fail(f"{name}: kernel disagrees with its plain version: max abs "
             f"err {err.max().item():.3e}, tolerance {tol} (atol = rtol)")
    return float(err.max().item())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def sl_case(gen, device, d_in, d_out, m, dtype, rank, delta, alpha, seed):
    """One SLTrain linear at real width: a sampled support in tile-CSR
    form, non-zero B (the paper init's B = 0 would hide the low-rank
    half), x of m rows."""
    from repro_torch.core import support
    from repro_torch.kernels import ops
    rows, cols = support.sample_support(seed, d_in, d_out, delta)
    cap = support.tile_cap(d_in, d_out, delta)
    tiles = ops.prepare_tile_consts(rows, cols, d_in, d_out, pad=cap)
    r = max(4, min(rank, min(d_in, d_out) // 2))

    def u(shape, lim):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                * lim).to(dtype)
    x = torch.randn((m, d_in), generator=gen, device=device).to(dtype)
    B = u((d_in, r), 1.0)
    A = u((r, d_out), (6.0 / d_in) ** 0.5)
    v = u((rows.shape[0],), d_in ** -0.5)
    rows_t = tiles["rows_t"].to(device)
    cols_t = tiles["cols_t"].to(device)
    v_t = ops._gather_tiles(v, tiles["perm"].to(device))
    return x, B, A, v_t, rows_t, cols_t, alpha / r


def check_sl_matmul(timer, gen, device, cfg, m_values):
    """Every row count the engine gives the kernel (a decode batch and
    each prefill bucket times the slots), so each row-block variant of
    the kernel is held against the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sl_matmul as slk
    d, f = cfg.d_model, cfg.d_ff
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for (d_in, d_out) in ((d, d), (d, f), (f, d)):
            for m in m_values:
                x, B, A, v_t, rt, ct, scale = sl_case(
                    gen, device, d_in, d_out, m, dtype, cfg.param.rank,
                    cfg.param.delta, cfg.param.alpha, seed=d_in * 7 + d_out)
                got = slk.sl_matmul(x, B, A, v_t, rt, ct, scale)
                want = ref.sl_matmul_ref(x, B, A, v_t, rt, ct, scale)
                torch.cuda.synchronize()
                err = compare(f"sl_matmul {d_in}->{d_out} M={m} {dtype}",
                              got, want, dtype)
                W = ref.densify_tiles(B, A, v_t, rt, ct, scale, dtype)
                W = W[:d_in, :d_out].contiguous()
                t_k = timer.ms(lambda: slk.sl_matmul(x, B, A, v_t, rt, ct,
                                                     scale))
                t_p = timer.ms(lambda: ref.sl_matmul_ref(x, B, A, v_t, rt,
                                                         ct, scale))
                t_l = timer.ms(lambda: torch.matmul(x, W))
                r = B.shape[1]
                ops_ = 2.0 * d_in * d_out * r + 2.0 * m * d_in * d_out
                b, by = bound_ms(nbytes(x, B, A, v_t, rt, ct, got), ops_,
                                 dtype)
                row = dict(name="sl_matmul", shape=f"{m}x{d_in}->{d_out} "
                           f"{str(dtype).split('.')[-1]}", max_abs_err=err,
                           tol=TOL[dtype], ms=t_k, plain_ms=t_p,
                           library_ms=t_l, bound_ms=b, bound_by=by)
                rows.append(row)
                say(f"kernel sl_matmul {row['shape']}: max_abs_err "
                    f"{err:.3e} (tol {TOL[dtype]}) | kernel {t_k:.4f} ms, "
                    f"plain {t_p:.4f} ms, torch.matmul on dense W "
                    f"{t_l:.4f} ms, bound {b:.4f} ms ({by})")
    return rows


def attn_case(gen, device, dtype, *, n_slots, n_kv, group, hd, block_len,
              bps, positions):
    """Random pools and a block table covering each slot's positions;
    positions[s] < 0 marks an idle slot (all-null row, position 0). The
    null block is filled with NaN: the kernels must never let it leak."""
    n_blocks = 1 + n_slots * bps
    shape = (n_blocks, block_len, n_kv, hd)
    k_pool = torch.randn(shape, generator=gen, device=device).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=device).to(dtype)
    k_pool[0] = float("nan")
    v_pool[0] = float("nan")
    table = torch.zeros((n_slots, bps), dtype=torch.int32)
    pos = torch.zeros(n_slots, dtype=torch.int32)
    nid = 1
    for s, p in enumerate(positions):
        if p < 0:
            continue
        pos[s] = p
        for j in range(p // block_len + 1):
            table[s, j] = nid
            nid += 1
    return k_pool, v_pool, table.to(device), pos.to(device)


def live_kv_bytes(k_pool, table, last_pos):
    """Bytes of K and V in the blocks a slot can see (non-null entries up
    to the block of its last query position)."""
    bl = k_pool.shape[1]
    per_block = k_pool[0].numel() * k_pool.element_size()
    t = table.cpu()
    n = 0
    for s in range(t.shape[0]):
        for j in range(min(t.shape[1], int(last_pos[s]) // bl + 1)):
            n += int(t[s, j] != 0)
    return 2 * n * per_block, n * bl


def sdpa_on_view(q, k_pool, v_pool, table, qpos, scale):
    """One library call as a yardstick: SDPA over the gathered view."""
    n_slots, bps = table.shape
    bl = k_pool.shape[1]
    k = k_pool[table.long()].reshape(n_slots, bps * bl, *k_pool.shape[2:])
    v = v_pool[table.long()].reshape(n_slots, bps * bl, *v_pool.shape[2:])
    kpos = torch.arange(bps * bl, device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    qh = q.transpose(1, 2)                      # (S, H, sq, hd)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    group = qh.shape[1] // kh.shape[1]
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    kh, vh = kh.contiguous(), vh.contiguous()
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qh, kh, vh, attn_mask=mask, scale=scale)


ATTN_CASES = (
    # (label, n_kv, group, softcap, window)
    ("32 heads", 32, 1, 0.0, 0),
    ("GQA group 4", 8, 4, 0.0, 0),
    ("softcap 50", 32, 1, 50.0, 0),
    ("window 24", 8, 4, 0.0, 24),
)


def check_attention(timer, gen, device, cfg, n_slots, block_len, bps,
                    sqs):
    """Decode, and chunked prefill at every suffix bucket in ``sqs``."""
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ref
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    rows = []
    positions = [min(bps * block_len - 1, 40 + 9 * s) for s in
                 range(n_slots - 1)] + [-1]          # last slot idle
    offsets = [16 * (s % 2) for s in range(n_slots - 1)] + [0]
    for dtype in (torch.bfloat16, torch.float32):
        for label, n_kv, group, cap, win in ATTN_CASES:
            kw = dict(scale=scale, softcap=cap, window=win)
            # decode
            kp, vp, tbl, pos = attn_case(
                gen, device, dtype, n_slots=n_slots, n_kv=n_kv, group=group,
                hd=hd, block_len=block_len, bps=bps, positions=positions)
            q = torch.randn((n_slots, n_kv, group, hd), generator=gen,
                            device=device).to(dtype)
            got = pak.paged_attention(q, kp, vp, tbl, pos, **kw)
            want = ref.paged_attention_ref(q, kp, vp, tbl, pos, **kw)
            torch.cuda.synchronize()
            err = compare(f"paged_attention {label} {dtype}", got, want,
                          dtype)
            kv_b, keys = live_kv_bytes(kp, tbl, pos)
            rows_q = n_slots * n_kv * group
            ops_ = 4.0 * rows_q / n_slots * keys * hd
            b, by = bound_ms(nbytes(q, tbl, pos, got) + kv_b, ops_, dtype)
            t_k = timer.ms(lambda: pak.paged_attention(q, kp, vp, tbl, pos,
                                                       **kw))
            t_p = timer.ms(lambda: ref.paged_attention_ref(
                q, kp, vp, tbl, pos, **kw))
            qd = q.reshape(n_slots, 1, n_kv * group, hd)
            t_l = timer.ms(sdpa_on_view(qd, kp, vp, tbl, pos[:, None],
                                        scale))
            rows.append(dict(name="paged_attention", shape=f"{label} "
                             f"{str(dtype).split('.')[-1]}",
                             max_abs_err=err, tol=TOL[dtype], ms=t_k,
                             plain_ms=t_p, library_ms=t_l, bound_ms=b,
                             bound_by=by))
            say(f"kernel paged_attention {label} {dtype}: max_abs_err "
                f"{err:.3e} (tol {TOL[dtype]}) | kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, SDPA on gathered view {t_l:.4f} ms, bound "
                f"{b:.4f} ms ({by})")
            for sq in sqs:
                rows.append(check_prefill(timer, gen, device, dtype, label,
                                          n_kv, group, hd, block_len, bps,
                                          sq, offsets, positions, kw))
    return rows


def check_prefill(timer, gen, device, dtype, label, n_kv, group, hd,
                  block_len, bps, sq, offsets, positions, kw):
    """Chunked suffix prefill: sq queries per slot at its offset; slots
    idle in ``positions`` get no pages (all-null rows)."""
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ref
    n_slots = len(offsets)
    offs = torch.tensor(offsets, dtype=torch.int32, device=device)
    pre_pos = [o + sq - 1 if p >= 0 else -1
               for o, p in zip(offsets, positions)]
    kp, vp, tbl, _ = attn_case(
        gen, device, dtype, n_slots=n_slots, n_kv=n_kv, group=group,
        hd=hd, block_len=block_len, bps=bps, positions=pre_pos)
    q = torch.randn((n_slots, sq, n_kv, group, hd), generator=gen,
                    device=device).to(dtype)
    got = pak.paged_prefill(q, kp, vp, tbl, offs, **kw)
    want = ref.paged_prefill_ref(q, kp, vp, tbl, offs, **kw)
    torch.cuda.synchronize()
    err = compare(f"paged_prefill sq={sq} {label} {dtype}", got, want,
                  dtype)
    kv_b, _ = live_kv_bytes(kp, tbl, offs + sq - 1)
    ops_ = 0.0
    for s in range(n_slots):
        if pre_pos[s] < 0:
            continue
        keys = offsets[s] + (sq + 1) / 2              # mean causal span
        ops_ += 4.0 * sq * n_kv * group * keys * hd
    b, by = bound_ms(nbytes(q, tbl, offs, got) + kv_b, ops_, dtype)
    t_k = timer.ms(lambda: pak.paged_prefill(q, kp, vp, tbl, offs, **kw))
    t_p = timer.ms(lambda: ref.paged_prefill_ref(q, kp, vp, tbl, offs,
                                                 **kw))
    qpos = offs[:, None] + torch.arange(sq, device=device)[None]
    qd = q.reshape(n_slots, sq, n_kv * group, hd)
    t_l = timer.ms(sdpa_on_view(qd, kp, vp, tbl, qpos, kw["scale"]))
    say(f"kernel paged_prefill sq={sq} {label} {dtype}: max_abs_err"
        f" {err:.3e} (tol {TOL[dtype]}) | kernel {t_k:.4f} ms, plain"
        f" {t_p:.4f} ms, SDPA on gathered view {t_l:.4f} ms, bound "
        f"{b:.4f} ms ({by})")
    return dict(name="paged_prefill", shape=f"sq={sq} {label} "
                f"{str(dtype).split('.')[-1]}", max_abs_err=err,
                tol=TOL[dtype], ms=t_k, plain_ms=t_p, library_ms=t_l,
                bound_ms=b, bound_by=by)


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving engine at llama_1b
# ---------------------------------------------------------------------------

def traffic(vocab: int, n: int = 8, seed: int = 0):
    """n requests: half open with one shared 16-token prefix (a whole
    block), tails of 2-8 tokens, Poisson arrival ticks."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab, size=16).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(3, vocab, size=int(rng.integers(2, 9))).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, np.cumsum(rng.poisson(2.0, size=n)).tolist()


def launch_counts():
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import sl_matmul as slk
    return {"sl_matmul": slk.sl_matmul.launches,
            "paged_attention": pak.paged_attention.launches,
            "paged_prefill": pak.paged_prefill.launches}


def reset_launch_counts():
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import sl_matmul as slk
    slk.sl_matmul.launches = 0
    pak.paged_attention.launches = 0
    pak.paged_prefill.launches = 0


def serve(cfg, params, consts, prompts, arrivals, *, exec_mode, attn_kernel,
          n_slots, max_len, block_len, new_tokens, device):
    """One engine run of the traffic through ``run_stream`` with prefix
    sharing; returns (requests, stats, engine, wall seconds). Each
    dispatch (one prefill or decode program) is bracketed by CUDA events:
    ``stats["span_s"]`` is the device time from each dispatch's start to
    its last kernel's end, summed, and ``stats["token_shapes"]`` the
    (slots, tokens per slot) of every dispatch, from which the row counts
    the kernels saw follow."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, consts, n_slots=n_slots, max_len=max_len,
                      paged=True, block_len=block_len, exec_mode=exec_mode,
                      attn_kernel=attn_kernel, prefix_sharing=True,
                      device=device)
    spans, shapes = [], set()

    def bracket(fn, kind):
        def run(params, consts, tokens, *args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(params, consts, tokens, *args, **kwargs)
            e.record()
            spans.append((s, e))
            shapes.add((kind, tuple(tokens.shape)))
            return out
        return run
    eng._prefill_fn = bracket(eng._prefill_fn, "prefill")
    eng._decode_fn = bracket(eng._decode_fn, "decode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=new_tokens, arrival=a)
            for p, a in zip(prompts, arrivals)]
    stats = eng.run_stream()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats["span_s"] = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    stats["token_shapes"] = shapes
    bad = [(r.uid, r.status) for r in reqs if r.status != "done"]
    if bad or stats["exhausted"] or len(stats["completed"]) != len(reqs):
        fail(f"{exec_mode}/{attn_kernel}: requests not completed: {bad}")
    for r in reqs:
        if len(r.out) != new_tokens or not all(0 <= t < cfg.vocab_size
                                               for t in r.out):
            fail(f"request {r.uid}: bad output {r.out}")
    return reqs, stats, eng, wall


def top2_gap(cfg, params, consts, tokens, device) -> float:
    """Path B's (dense) top-2 logit gap for the next token after
    ``tokens``: a tie explains a greedy divergence, anything larger is a
    fault."""
    from repro_torch.models import lm
    dense = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="dense"))
    toks = torch.tensor([tokens], dtype=torch.int64, device=device)
    logits, _ = lm.apply_lm(dense, params, consts, toks)
    top = logits[0, -1, :cfg.vocab_size].float().topk(2).values
    return float(top[0] - top[1])


def randomize_b(params, gen):
    """B = 0 in the paper init would multiply away the low-rank half of
    every kernel: draw it U(-1, 1) instead."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "B":
                v.uniform_(-1.0, 1.0, generator=gen)
    walk(params)


def phase_engine_f32(cfg, params, consts, prompts, arrivals, device, **kw):
    """Phase 3: the f32 engine along path A (fused sl_matmul + paged
    kernels) and path B (dense densify + gathered attention)."""
    reset_launch_counts()
    a_reqs, a_stats, _, a_wall = serve(cfg, params, consts, prompts,
                                       arrivals, exec_mode="fused",
                                       attn_kernel="paged", device=device,
                                       **kw)
    a_launches = launch_counts()
    reset_launch_counts()
    b_reqs, _, _, b_wall = serve(cfg, params, consts, prompts, arrivals,
                                 exec_mode="dense", attn_kernel="gather",
                                 device=device, **kw)
    b_launches = launch_counts()
    if any(b_launches.values()):
        fail(f"path B (dense/gather) launched kernels: {b_launches}")
    if not all(a_launches.values()):
        fail(f"path A (fused/paged) missed a kernel: {a_launches}")
    ties, same = [], 0
    for ra, rb in zip(a_reqs, b_reqs):
        for i, (ta, tb) in enumerate(zip(ra.out, rb.out)):
            if ta == tb:
                same += 1
                continue
            gap = top2_gap(cfg, params, consts, rb.prompt + rb.out[:i],
                           device)
            if gap >= 1e-4:
                fail(f"f32 request {ra.uid} token {i}: fused/paged {ta} vs "
                     f"dense/gather {tb}, path B top-2 gap {gap:.3e} "
                     "(not a tie)")
            ties.append((ra.uid, i, gap))
            break
    total = sum(len(r.out) for r in a_reqs)
    say(f"engine f32 llama_1b: {len(a_reqs)} requests, {total} tokens; "
        f"fused/paged == dense/gather on {same}/{total} tokens"
        + (f", ties (uid, token, top-2 gap): {ties}" if ties else "")
        + f" | path A {a_wall:.2f} s launches {a_launches}, path B "
        f"{b_wall:.2f} s")
    return a_stats["token_shapes"]


def check_forward(cfg, params, consts, device):
    """The plain forward on a small input: finite logits of the expected
    shape, fused against dense within f32 tolerance."""
    from repro_torch.models import lm
    toks = torch.arange(3, 19, device=device)[None]
    out = {}
    for mode in ("fused", "dense"):
        c = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, exec_mode=mode))
        out[mode], _ = lm.apply_lm(c, params, consts, toks)
    want = (1, 16, cfg.padded_vocab)
    for mode, lg in out.items():
        if tuple(lg.shape) != want or not torch.isfinite(lg).all():
            fail(f"apply_lm {mode}: shape {tuple(lg.shape)} (want {want}) "
                 "or non-finite logits")
    err = (out["fused"] - out["dense"]).abs().max().item()
    scale = out["dense"].abs().max().item()
    if err > 1e-3 * max(1.0, scale):
        fail(f"apply_lm fused vs dense: max abs err {err:.3e} at logit "
             f"scale {scale:.3e}")
    say(f"forward f32 llama_1b: logits {want} finite, fused vs dense max "
        f"abs err {err:.3e} (tol 1e-3 x max(1, {scale:.2f}))")


def phase_engine_bf16(cfg, params, consts, prompts, arrivals, device, **kw):
    """Phase 4: the main path in bf16 (fused + paged), timed, with every
    kernel's launch count read around the run."""
    reset_launch_counts()
    reqs, stats, eng, wall = serve(cfg, params, consts, prompts, arrivals,
                                   exec_mode="fused", attn_kernel="paged",
                                   device=device, **kw)
    launches = launch_counts()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"bf16 main path never launched {missing}: {launches}")
    tokens = sum(len(r.out) for r in reqs)
    hw = eng.obs.histogram("serve.ttft_wall_ms")
    ttft_ms = sorted((r.wall_first - r.wall_arrival) * 1e3 for r in reqs)
    ticks = sorted(r.t_first - r.arrival for r in reqs)
    span = stats["span_s"]
    say(f"engine bf16 llama_1b (fused sl_matmul + paged kernels): "
        f"{len(stats['completed'])}/{len(reqs)} requests done, {tokens} "
        f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s, "
        f"{stats['decode_steps']} decode steps, "
        f"{eng.dispatches['prefill']} prefills, prefix tokens shared "
        f"{eng.prefill_traffic['tokens_shared']}/"
        f"{eng.prefill_traffic['tokens_total']} | TTFT wall ms p50 "
        f"{statistics.median(ttft_ms):.1f} max {ttft_ms[-1]:.1f} "
        f"(histogram p50 {hw.percentile(50):.1f}), ticks p50 "
        f"{statistics.median(ticks)} max {ticks[-1]} | launches {launches}")
    # the device runs nothing between dispatches but the copies of each
    # dispatch's few input and output integers: the wall time outside the
    # dispatch spans is idle time spent on the host's scheduling; idle
    # gaps inside a span (the host launching the next op) are not seen
    say(f"engine bf16 dispatch spans, same run: {span:.3f} s of device time "
        f"from each dispatch's start to its last kernel's end, of wall "
        f"{wall:.3f} s: idle between dispatches "
        f"{100 * (1 - span / wall):.1f}% (CUDA events around each dispatch)")
    return launches, stats["token_shapes"], wall


def check_coverage(shapes, m_values, sqs):
    """Every row count the engine gave ``sl_matmul`` and every suffix
    length it gave ``paged_prefill`` was held against the plain version."""
    ms = {int(np.prod(s)) for _, s in shapes}
    pre = {s[1] for kind, s in shapes if kind == "prefill"}
    if not ms <= set(m_values) or not pre <= set(sqs):
        fail(f"the engine ran sl_matmul at M in {sorted(ms)} and "
             f"paged_prefill at sq in {sorted(pre)}; checked only M in "
             f"{sorted(m_values)} and sq in {sorted(sqs)}")
    say(f"coverage: the engine ran sl_matmul at M in {sorted(ms)} and "
        f"paged_prefill at sq in {sorted(pre)}, all checked above")


def phase_profile(cfg, params, consts, prompts, arrivals, device,
                  plain_wall, **kw):
    """Phase 5: where the time of a bf16 engine run goes — device busy
    share and the kernels by device time, from ``torch.profiler``. After
    the launch counts are read; it drives the same run once more, under a
    profiler that records device activity only (no host-side op records,
    which would slow the host and inflate the idle share). Busy and wall
    time come from this one run; ``plain_wall`` (the unprofiled run's
    wall) shows how far the profiler still slowed it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, stats, _, wall = serve(cfg, params, consts, prompts, arrivals,
                                  device=device, **kw)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        say("profile: the profiler recorded no device time (not measured)")
        return
    busy_us, spans = 0.0, sorted((e.time_range.start, e.time_range.end)
                                 for e in events)
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:                      # union of kernel intervals
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in events:
        n = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                "")
        by_name[n] = by_name.get(n, 0.0) + \
            (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    total = sum(by_name.values())
    say(f"profile bf16 engine run ({stats['decode_steps']} decode steps, "
        f"device-only profiler on): wall {wall:.3f} s (unprofiled run "
        f"{plain_wall:.3f} s), device busy {busy_us / 1e6:.3f} s = "
        f"{100 * busy_us / 1e6 / wall:.1f}% (idle "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}%, same run); device time by "
        "kernel: " + "; ".join(f"{n[:48]} {100 * t / total:.1f}%"
                               for n, t in top))


def kernels_line(rows, launches, representative):
    """One entry per kernel: the representative case's times and bound,
    the largest error over all of the kernel's cases."""
    out = []
    src = {"sl_matmul": SL_SOURCE, "paged_attention": PA_SOURCE,
           "paged_prefill": PA_SOURCE}
    for name, shape in representative.items():
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["shape"] == shape)
        out.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shape": shape,
            "cases": len(mine)})
    return {"kernels": out}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    from repro_torch.configs import llama_1b
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"device: {name} x{torch.cuda.device_count()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    say(smi)

    t0 = time.perf_counter()
    build.build()
    say(f"build: {len(build.SOURCES)} kernels with nvcc in "
        f"{time.perf_counter() - t0:.1f} s (parallel, sm_90a)")
    for lib in build.SOURCES:
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {lib}: {line.strip()}")

    cfg = llama_1b.CONFIG
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    timer = Timer(device)
    n_slots, block_len, max_len = 4, 16, 128
    # prefill pads each slot's suffix to a power of two, at least 8
    # (scheduler min_prefill_bucket); this traffic's suffixes fit in 32
    buckets = (8, 16, 32)
    m_values = (n_slots,) + tuple(n_slots * b for b in buckets)
    sl_rows = check_sl_matmul(timer, gen, device, cfg, m_values)
    at_rows = check_attention(timer, gen, device, cfg, n_slots, block_len,
                              max_len // block_len, buckets)
    del timer                       # free the L2 sweep buffer

    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    params, consts = lm.init_lm(cfg32, seed=0, device=device)
    randomize_b(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    say(f"init llama_1b: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, rank {cfg.param.rank}, {n_params / 1e6:.1f} M params, "
        f"consts {sum(nbytes(t) for _, t in tree_leaves(consts)) / 2**30:.2f} "
        f"GiB, in {time.perf_counter() - t0:.1f} s")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    check_forward(cfg32, params, consts, device)
    shapes = phase_engine_f32(cfg32, params, consts, prompts, arrivals,
                              device, **kw)

    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    launches, shapes16, wall16 = phase_engine_bf16(
        cfg16, params16, consts, prompts, arrivals, device, **kw)
    check_coverage(shapes | shapes16, m_values, buckets)
    phase_profile(cfg16, params16, consts, prompts, arrivals, device,
                  wall16, exec_mode="fused", attn_kernel="paged", **kw)
    line = kernels_line(sl_rows + at_rows, launches, {
        "sl_matmul": f"{n_slots}x{cfg.d_model}->{cfg.d_ff} bfloat16",
        "paged_attention": "32 heads bfloat16",
        "paged_prefill": f"sq={buckets[-1]} 32 heads bfloat16"})
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
