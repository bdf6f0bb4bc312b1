"""Fixed random sparse support for SLTrain (paper §3.2, §3.3), a copy of
``repro.core.support`` that must stay bit-identical to it
(tests/test_torch_support.py holds the two together).

The support I is sampled once at init on the host (numpy), keyed by an
integer seed, and never learned:

  * ``sample_support`` — (rows, cols) int32, iid-uniform (paper) or
    row-balanced (each row gets exactly k = round(delta*d_out) entries).
  * ``nnz_for`` / ``tile_cap`` — deterministic sizes from the shape.
  * ``tile_layout`` — the tile-CSR layout the ``sl_matmul`` kernel reads:
    entries bucketed by 128×128 tile, padded to a uniform per-tile
    capacity with entries at local (0, 0) whose value is 0.
  * ``final_support`` — what one SLTrain linear keeps: its support and,
    at a capacity, its tile index arrays, re-sampled with a bumped seed
    while a tile overflows (the reference's ``prepare_fused_consts``).
  * ``sample_supports`` — ``final_support`` for many linears, in worker
    processes: each support is keyed by its own seed, so the order of the
    work changes no bit; ``keep_supports`` lets a process that inits one
    model several times sample each support once. This module imports
    numpy only, and a worker is a fresh interpreter that imports it
    alone: neither torch nor the rest of the port, nor the caller's main
    module.
"""
from __future__ import annotations

import collections
import contextlib
import os
from typing import Optional, Sequence, Tuple

import numpy as np

# Kernel tile edge: the sl_matmul kernel densifies W one TILE×TILE tile
# at a time.
TILE = 128

# Above this many elements the row-balanced sampler draws its random keys
# in row blocks instead of one (d_in, d_out) matrix (same PRNG stream, so
# both branches give identical supports). Module-level so tests can
# shrink it to exercise the blocked branch on small shapes.
DENSE_KEYS_ELEMS = 1 << 26

# Seed stride of the re-sample when a sampled support exceeds a tile
# capacity; the reference's ``_RESAMPLE_STRIDE``, so both packages
# re-derive the same final support.
RESAMPLE_STRIDE = 0x9E3779B1
RESAMPLE_ATTEMPTS = 16

# The tile index consts of the fused and sparse kernels, in the order
# ``tile_index_arrays`` returns them.
TILE_CONSTS = ("rows_t", "cols_t", "perm")

# Supports of fewer summed elements (d_in·d_out over the linears) than
# this are sampled in one process: below it (a few seconds of numpy)
# starting workers and moving the arrays through files saves little.
# llama_350m (302 M elements) and larger are pooled.
POOL_MIN_ELEMS = 1 << 28
# At most this many workers: each holds up to DENSE_KEYS_ELEMS f32 keys
# and their int64 argpartition, ~0.8 GB.
MAX_WORKERS = 8


def nnz_for(d_in: int, d_out: int, delta: float, kind: str = "row_balanced") -> int:
    """Number of nonzeros; deterministic function of the shape and delta."""
    if kind == "row_balanced":
        k = max(1, int(round(delta * d_out)))
        return d_in * k
    return max(1, int(round(delta * d_in * d_out)))


def tile_cap(d_in: int, d_out: int, delta: float,
             kind: str = "row_balanced", tile_r: int = TILE,
             tile_c: int = TILE) -> int:
    """Deterministic per-tile capacity for the tile-CSR layout: mean
    entries per tile plus an 8·sqrt(mean) + 16 tail margin, clamped to the
    per-tile maximum and rounded up to a multiple of 8. Init re-samples
    the support in the rare case a tile overflows it."""
    rows_in_tile = min(tile_r, d_in)
    cols_in_tile = min(tile_c, d_out)
    if kind == "row_balanced":
        k = max(1, int(round(delta * d_out)))
        mean = rows_in_tile * k * (cols_in_tile / d_out)
        hard = rows_in_tile * min(k, cols_in_tile)
    else:
        nnz = nnz_for(d_in, d_out, delta, kind)
        mean = nnz * (rows_in_tile * cols_in_tile) / (d_in * d_out)
        hard = rows_in_tile * cols_in_tile
    cap = int(np.ceil(mean + 8.0 * np.sqrt(mean) + 16.0))
    cap = min(cap, int(hard))
    return max(8, ((cap + 7) // 8) * 8)


def _row_balanced_cols(rng: np.random.Generator, d_in: int, d_out: int,
                       k: int) -> np.ndarray:
    """Per-row k-subset sampling via argpartition of random keys, in row
    blocks above DENSE_KEYS_ELEMS (PCG64 fills C-order from one stream, so
    the blocked draw reproduces the full-matrix draw bit for bit)."""
    block = d_in if d_in * d_out <= DENSE_KEYS_ELEMS else \
        max(1, DENSE_KEYS_ELEMS // d_out)
    out = np.empty((d_in, k), dtype=np.int32)
    for i0 in range(0, d_in, block):
        b = min(block, d_in - i0)
        keys = rng.random((b, d_out), dtype=np.float32)
        if k >= d_out:          # degenerate: every column is in the support
            out[i0:i0 + b] = np.arange(d_out, dtype=np.int32)
        else:
            out[i0:i0 + b] = np.argpartition(keys, k, axis=1)[:, :k]
    return out


def sample_support(
    seed: int, d_in: int, d_out: int, delta: float, kind: str = "row_balanced"
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample the fixed support. Returns (rows, cols) int32, row-major sorted."""
    rng = np.random.default_rng(np.uint64(seed))
    if kind == "row_balanced":
        k = max(1, int(round(delta * d_out)))
        cols = _row_balanced_cols(rng, d_in, d_out, k)
        cols.sort(axis=1)
        rows = np.repeat(np.arange(d_in, dtype=np.int32), k)
        return rows, cols.reshape(-1)
    nnz = nnz_for(d_in, d_out, delta, kind)
    total = d_in * d_out
    flat = rng.choice(total, size=nnz, replace=False)
    flat.sort()
    rows = (flat // d_out).astype(np.int32)
    cols = (flat % d_out).astype(np.int32)
    return rows, cols


def tile_layout(
    rows: np.ndarray,
    cols: np.ndarray,
    d_in: int,
    d_out: int,
    tile_r: int = TILE,
    tile_c: int = TILE,
    pad: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Bucket support entries by (row-tile, col-tile).

    Returns (perm, local_rc, tile_counts, pad_per_tile):
      * perm        int32[n_tiles * pad] — index into the original (rows,
                    cols, values) arrays, -1 for padding slots,
      * local_rc    int32[n_tiles * pad, 2] — (row, col) local to the
                    tile; padding slots point at (0, 0),
      * tile_counts int32[nt_r, nt_c] — real entries per tile,
      * pad_per_tile — the uniform per-tile capacity: the realized max
                    rounded up to a multiple of 8, or ``pad`` when given
                    (raises ``ValueError`` when the realized max exceeds
                    it, so callers can re-sample).
    """
    nt_r = (d_in + tile_r - 1) // tile_r
    nt_c = (d_out + tile_c - 1) // tile_c
    t_id = (rows // tile_r).astype(np.int64) * nt_c + (cols // tile_c)
    order = np.argsort(t_id, kind="stable")
    t_sorted = t_id[order]
    counts = np.bincount(t_sorted, minlength=nt_r * nt_c).astype(np.int32)
    max_count = int(counts.max()) if counts.size else 0
    if pad is None:
        pad = max(8, ((max_count + 7) // 8) * 8)
    elif max_count > pad:
        raise ValueError(
            f"tile_layout: realized per-tile max {max_count} exceeds the "
            f"requested capacity {pad} — re-sample the support")
    n_tiles = nt_r * nt_c
    perm = np.full((n_tiles, pad), -1, dtype=np.int32)
    local = np.zeros((n_tiles, pad, 2), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for t in range(n_tiles):
        c = counts[t]
        if c == 0:
            continue
        idx = order[starts[t] : starts[t] + c]
        perm[t, :c] = idx
        local[t, :c, 0] = rows[idx] % tile_r
        local[t, :c, 1] = cols[idx] % tile_c
    return perm.reshape(-1), local.reshape(-1, 2), counts.reshape(nt_r, nt_c), pad


def tile_index_arrays(rows: np.ndarray, cols: np.ndarray, d_in: int,
                      d_out: int, pad: Optional[int], tile_r: int = TILE,
                      tile_c: int = TILE):
    """Pad dims to tile multiples, bucket the support and shape the index
    arrays: (rows_t, cols_t, perm), each int32 (K/tile_r, N/tile_c, E),
    contiguous. Raises ``ValueError`` when a tile holds more than ``pad``
    entries (callers re-sample)."""
    kp = ((d_in + tile_r - 1) // tile_r) * tile_r
    np_ = ((d_out + tile_c - 1) // tile_c) * tile_c
    perm, local, counts, pad = tile_layout(
        rows, cols, kp, np_, tile_r, tile_c, pad=pad)
    nkt, nnt = kp // tile_r, np_ // tile_c
    rt = local[:, 0].reshape(nkt, nnt, pad).astype(np.int32)
    ct = local[:, 1].reshape(nkt, nnt, pad).astype(np.int32)
    return rt, ct, np.ascontiguousarray(perm.reshape(nkt, nnt, pad))


def fit_tiles(rows: np.ndarray, cols: np.ndarray, d_in: int, d_out: int,
              delta: float, kind: str, seed: int, cap: int):
    """(rows, cols, tile index arrays) at capacity ``cap``: a support that
    busts it is re-sampled from ``seed + i * RESAMPLE_STRIDE`` (i = 1,
    2, ...), as the reference's ``prepare_fused_consts`` does."""
    for attempt in range(RESAMPLE_ATTEMPTS):
        try:
            return rows, cols, tile_index_arrays(rows, cols, d_in, d_out,
                                                 pad=cap)
        except ValueError:
            rows, cols = sample_support(
                seed + (attempt + 1) * RESAMPLE_STRIDE, d_in, d_out, delta,
                kind)
    raise ValueError(
        f"fused tile capacity {cap} too small for ({d_in}, {d_out}, "
        f"delta={delta}, {kind}) after {RESAMPLE_ATTEMPTS} re-samples — "
        "support.tile_cap bound is broken for this shape")


def final_support(seed: int, d_in: int, d_out: int, delta: float,
                  kind: str = "row_balanced", cap: Optional[int] = None):
    """The support one SLTrain linear keeps: (rows, cols, tiles), int32.
    ``tiles`` is None without a capacity; with one, the tile index arrays
    (``TILE_CONSTS``) of the support that fits it (``fit_tiles``)."""
    rows, cols = sample_support(seed, d_in, d_out, delta, kind)
    if cap is None:
        return rows, cols, None
    return fit_tiles(rows, cols, d_in, d_out, delta, kind, seed, cap)


def default_workers(specs: Sequence[tuple]) -> int:
    """Worker processes for ``sample_supports(specs)``: 1 below
    ``POOL_MIN_ELEMS`` summed elements, else one per usable CPU up to
    ``MAX_WORKERS`` and the number of specs."""
    elems = sum(d_in * d_out for _, d_in, d_out, *_ in specs)
    if elems < POOL_MIN_ELEMS:
        return 1
    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    return max(1, min(MAX_WORKERS, cpus, len(specs)))


def sample_supports(specs: Sequence[tuple], workers: int = 1) -> list:
    """``final_support(*spec)`` for each spec (seed, d_in, d_out, delta,
    kind, cap), in order. ``workers`` > 1 runs them in that many worker
    processes, fresh interpreters that import numpy and this module only
    (never forked: the caller may have initialised CUDA), each given a
    share of the specs balanced by size; they write the int32 arrays as
    ``.npy`` files into a temporary directory, which threads read back
    here (a ``ProcessPoolExecutor``'s pipe returned a llama_7b init's ~7
    GB no faster than one process sampled them; chip_smoke.py's phase 7c
    on an H100 host: 121.3 s, through files 26.3 s). ``workers`` = 1
    runs them here. Each support depends on its own spec alone, so both
    give the same bits. Inside ``keep_supports`` a spec sampled before is
    not sampled again (see there)."""
    specs = [tuple(s) for s in specs]
    if _KEPT is None:
        return _sample(specs, workers)
    todo = [s for s in dict.fromkeys(specs) if s not in _KEPT]
    new = dict(zip(todo, _sample(todo, min(workers,
                                           default_workers(todo)))))
    out = [_copy(new[s] if s in new else _KEPT[s]) for s in specs]
    for spec, res in new.items():
        _keep(spec, res)
    return out


def _sample(specs: list, workers: int) -> list:
    if workers <= 1 or len(specs) <= 1:
        return [final_support(*s) for s in specs]
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    workers = min(workers, len(specs))
    with tempfile.TemporaryDirectory(prefix="sltrain-supports-") as tmp:
        _run_workers(specs, workers, tmp)
        with ThreadPoolExecutor(workers) as pool:
            return list(pool.map(lambda i: _load_support(tmp, i),
                                 range(len(specs))))


def sample_ahead(specs: Sequence[tuple], workers: int):
    """Start sampling ``specs`` in a background thread (``workers``
    processes, as :func:`sample_supports` runs them) while the caller
    goes on; returns ``keep``, which waits for the thread, raises what it
    raised, and inside :func:`keep_supports` keeps what it sampled, so the
    inits that then ask for those specs copy them: the same bits, since a
    support depends on its spec alone. For a program whose host has idle
    cores before a large init; the thread never touches what
    ``keep_supports`` holds, and is no daemon: a program that ends before
    ``keep`` waits for it, so its workers and their files end with it."""
    import threading
    todo = list(dict.fromkeys(tuple(s) for s in specs))
    if _KEPT is not None:
        todo = [s for s in todo if s not in _KEPT]
    box = {}

    def work():
        try:
            box["out"] = _sample(todo, workers)
        except BaseException as e:            # re-raised by keep()
            box["err"] = e
    th = threading.Thread(target=work)
    th.start()

    def keep() -> None:
        th.join()
        if "err" in box:
            raise box["err"]
        if _KEPT is not None:
            for spec, res in zip(todo, box["out"]):
                if spec not in _KEPT:
                    _keep(spec, res)
    return keep


# What ``sample_supports`` sampled inside ``keep_supports``, by spec,
# oldest first, and the bytes it holds; None outside it.
_KEPT: Optional["collections.OrderedDict"] = None
_KEPT_MAX = 0
_kept_bytes = 0


@contextlib.contextmanager
def keep_supports(max_bytes: int):
    """Within the block, ``sample_supports`` keeps what it samples, up to
    ``max_bytes`` of arrays (the oldest dropped first), and answers a spec
    it kept with a copy in place of sampling it again: the same bits,
    since a support depends on its spec alone. For a program that inits
    one model several times (in several dtypes, exec modes or depth
    cuts); a process that inits once gains nothing from it."""
    global _KEPT, _KEPT_MAX, _kept_bytes
    _KEPT, _KEPT_MAX, _kept_bytes = collections.OrderedDict(), max_bytes, 0
    try:
        yield
    finally:
        _KEPT, _KEPT_MAX, _kept_bytes = None, 0, 0


def _arrays(res) -> tuple:
    rows, cols, tiles = res
    return (rows, cols) + (() if tiles is None else tuple(tiles))


def _copy(res):
    rows, cols, tiles = res
    return (rows.copy(), cols.copy(),
            None if tiles is None else tuple(t.copy() for t in tiles))


def _keep(spec: tuple, res) -> None:
    global _kept_bytes
    size = sum(a.nbytes for a in _arrays(res))
    if size > _KEPT_MAX:
        return
    while _kept_bytes + size > _KEPT_MAX:
        _kept_bytes -= sum(a.nbytes for a in _arrays(
            _KEPT.popitem(last=False)[1]))
    _KEPT[spec] = res
    _kept_bytes += size


# where ``repro_torch`` lives, for the workers' ``sys.path``
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_WORKER = ("import sys; sys.path.insert(0, {src!r}); "
           "from repro_torch.core.support import _worker; _worker()")
_ARRAYS = ("rows", "cols") + TILE_CONSTS


def _run_workers(specs, workers: int, out_dir: str) -> None:
    """Start ``workers`` sampling processes on shares of ``specs`` (the
    largest first, each to the least loaded worker) and wait for all;
    raise if one fails, and leave none running."""
    import pickle
    import subprocess
    import sys
    shares = [[] for _ in range(workers)]
    load = [0] * workers
    for i in sorted(range(len(specs)),
                    key=lambda i: -specs[i][1] * specs[i][2]):
        w = load.index(min(load))
        shares[w].append((i, specs[i]))
        load[w] += specs[i][1] * specs[i][2]
    cmd = [sys.executable, "-c", _WORKER.format(src=_SRC)]
    procs = []
    try:
        for share in shares:
            p = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((out_dir, share)))
            p.stdin.close()
        for p in procs:
            err = p.stderr.read()
            if p.wait():
                raise RuntimeError(
                    f"support sampling worker exited with {p.returncode}: "
                    f"{err.decode(errors='replace')[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stderr.close()


def _worker() -> None:
    """A sampling worker's body: reads (out_dir, [(index, spec), ...]),
    pickled by ``_run_workers``, from stdin and writes each
    ``final_support``'s arrays to ``{out_dir}/{index}-{name}.npy``."""
    import pickle
    import sys
    out_dir, share = pickle.load(sys.stdin.buffer)
    for i, spec in share:
        rows, cols, tiles = final_support(*spec)
        arrays = (rows, cols) + (() if tiles is None else tiles)
        for name, a in zip(_ARRAYS, arrays):
            np.save(os.path.join(out_dir, f"{i}-{name}.npy"), a)


def _load_support(out_dir: str, i: int):
    """The (rows, cols, tiles) a worker wrote for spec ``i``."""
    path = lambda name: os.path.join(out_dir, f"{i}-{name}.npy")
    rows, cols = np.load(path("rows")), np.load(path("cols"))
    if not os.path.exists(path(TILE_CONSTS[0])):
        return rows, cols, None
    return rows, cols, tuple(np.load(path(n)) for n in TILE_CONSTS)
