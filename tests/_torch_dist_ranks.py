"""Rank bodies of the CPU mesh tests (``tests/test_torch_dist*.py``):
gloo worlds of spawned processes meet through a ``FileStore`` under the
test's ``tmp_path`` (pytest-xdist runs several workers at once, so no TCP
port is shared). This module imports torch, numpy and the port only: a
rank never imports jax. The parent computes the reference's numbers and
hands the ranks numpy arrays; each rank returns picklable results.
``serve_rank`` and the helpers above it run the serving cases of
``tests/test_torch_dist_serve.py`` (the parent runs the same engines in
one process through them)."""
from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store_dir, fn, args, out_dir):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        result = ("ok", fn(rank, world, *args))
    except Exception:
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(world: int, fn, tmp_dir, *args, timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks;
    returns the list of their results (raises with a rank's traceback if
    one failed, and stops the ranks if they outlast ``timeout`` s)."""
    tmp_dir = str(tmp_dir)
    run_dir = os.path.join(tmp_dir, f"world{len(os.listdir(tmp_dir))}")
    os.makedirs(run_dir)
    ctx = mp.start_processes(_entry, args=(world, run_dir, fn, args,
                                           run_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a gloo world of {world} ranks ran past "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        out.append(value)
    return out


# ---------------------------------------------------------------------------
# Serving on a mesh (tests/test_torch_dist_serve.py)
# ---------------------------------------------------------------------------

# the engine of every serving case: 4 slots, prompts of up to 23 tokens
SERVE_KW = dict(n_slots=4, max_len=64, block_len=8)
NEW_TOKENS = 6


def serve_prompts(vocab: int, paged: bool, n: int = 6, seed: int = 0):
    """``n`` seeded prompts of 2 to 7 tokens; for the paged engine every
    other one opens with a shared 16-token prefix (two blocks: the engine
    attaches them and prefills the suffix through the per-slot prefill).
    The contiguous engine prefills one dispatch a prompt token, so its
    prompts carry no prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab, 16).tolist()
    return [(shared if paged and i % 2 == 0 else []) +
            rng.integers(3, vocab, int(rng.integers(2, 8))).tolist()
            for i in range(n)]


def serve_run(eng, prompts):
    """Each request's (uid, status, tokens, admit, first and done ticks)
    after the engine drained ``prompts``."""
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    stats = eng.run_until_drained()
    assert not stats["exhausted"]
    return [(r.uid, r.status, r.out, r.t_admit, r.t_first, r.t_done)
            for r in reqs]


def serve_engine(cfg, trees, *, paged, exec_mode, attn_kernel, mesh=None):
    """The engine of one case on the CPU (``trees``: the port's params
    and consts as numpy)."""
    from repro_torch.serve.engine import ServeEngine
    tree = lambda t: {k: tree(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.from_numpy(t.copy())
    return ServeEngine(cfg, tree(trees[0]), tree(trees[1]), paged=paged,
                       prefix_sharing=paged, exec_mode=exec_mode,
                       attn_kernel=attn_kernel if paged else None,
                       mesh=mesh, device="cpu", **SERVE_KW)


class _Collectives:
    """Every collective a rank's dispatches make while it is active: per
    dispatch its tokens' shape and the elements each all-gather
    contributed, and the count of any other collective."""

    NAMES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor")

    def __init__(self, compat):
        self.compat = compat
        self.dispatches = []
        self.others = 0

    def __enter__(self):
        self._orig = [getattr(self.compat, n) for n in self.NAMES]
        gather = self._orig[0]

        def all_gather(out, inp, group):
            if self.dispatches:
                self.dispatches[-1][1].append(inp.numel())
            return gather(out, inp, group)

        def other(fn):
            def run(*a, **k):
                self.others += 1
                return fn(*a, **k)
            return run
        self.compat.all_gather_into_tensor = all_gather
        self.compat.all_reduce = other(self._orig[1])
        self.compat.reduce_scatter_tensor = other(self._orig[2])
        return self

    def __exit__(self, *exc):
        for n, fn in zip(self.NAMES, self._orig):
            setattr(self.compat, n, fn)

    def wrap(self, fn):
        def run(params, consts, tokens, *a, **k):
            self.dispatches.append((tuple(tokens.shape), []))
            return fn(params, consts, tokens, *a, **k)
        return run


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def serve_rank(rank, world, meshes, trees):
    """Each case of ``meshes`` ([(mesh shape, [(name, tree key, port
    config, paged, exec_mode, attn_kernel)])]) served on its (data,
    model) mesh of this world: {name: its requests, the rank's cache leaf
    shapes, its column slices by linear path (width, consts key: "tp"
    all-gathered, "tp_heads" kept local), the collectives a dispatch
    (``_Collectives``) and whether any weight leaf changed}."""
    from repro_torch.dist import compat
    out = {}
    for shape, cases in meshes:
        mesh = compat.make_mesh(shape, ("data", "model"))
        for name, key, cfg, paged, mode, attn in cases:
            eng = serve_engine(cfg, trees[key], paged=paged, exec_mode=mode,
                               attn_kernel=attn, mesh=mesh)
            weights = list(_leaves({"params": eng.params,
                                    "consts": eng.consts}))
            before = [(t.data_ptr(), t._version) for _, t in weights]
            with _Collectives(compat) as log:
                if paged:
                    eng._prefill_fn = log.wrap(eng._prefill_fn)
                eng._decode_fn = log.wrap(eng._decode_fn)
                reqs = serve_run(eng, serve_prompts(cfg.vocab_size, paged))
            out[name] = {
                "requests": reqs,
                "cache": {p: tuple(t.shape) for p, t in
                          _leaves(eng.cache)},
                "columns": {p[:-2]: (t.shape[-1], key) for p, t in
                            _leaves(eng.params) if p.endswith("/A")
                            for key in ("tp", "tp_heads")
                            if key in _node(eng.consts, p[:-2])},
                "dispatches": log.dispatches, "others": log.others,
                "weights_moved": before != [(t.data_ptr(), t._version)
                                            for _, t in weights]}
    return out


def _node(tree, path):
    for k in path.split("/"):
        tree = tree.get(k, {}) if isinstance(tree, dict) else {}
    return tree
