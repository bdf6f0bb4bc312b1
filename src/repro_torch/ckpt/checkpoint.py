"""Atomic, checksummed checkpoints in the reference's on-disk format,
and the versioned int8 quant artifact, ported from
``repro.ckpt.checkpoint``.

Layout per checkpoint:   <dir>/step_<N:08d>/
    manifest.json   — step, config hash, data-pipeline state, leaf keys,
                      logical dtypes, CRC32 per stored array, sha256 digest
    arrays.npz      — one entry per leaf, keyed by "/"-joined tree path

Keys are the reference's: "/"-joined dict paths of the same nested trees
(params, and the AdamW state {"mu", "nu", "step"}). bf16 leaves are stored
as uint16 bit-views with "bfloat16" in the manifest. So the two packages
restore each other's checkpoints bit for bit.

Guarantees, as the reference's:
  * atomic: written to ``step_<N>.tmp`` then ``os.replace``d,
  * async: ``save(..., background=True)`` copies the tensors to host
    memory synchronously and writes on a daemon thread; ``wait()`` joins
    before the next save or exit,
  * elastic: leaves are saved whole (a trainer on a mesh gathers its
    shards first); ``restore(..., shardings=...)`` cuts each to this
    rank's shard on the current mesh,
  * self-validating: restore checks the config hash,
  * corruption-detecting: restore verifies the per-array CRC32s and the
    manifest digest and raises :class:`CheckpointCorruptError` on damage;
    with ``step=None`` it falls back to the newest intact step.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.common import tree_leaves

_SEP = "/"
# npz holds native numpy dtypes only: bf16 travels as its uint16 bits
# (moved through int16, a dtype both numpy and torch convert fully)
_BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (checksum/digest
    mismatch, unreadable npz/manifest). Distinct from config/shape
    mismatches, which are caller errors and stay ``ValueError``."""


def _crc(arr: np.ndarray) -> int:
    # the crc of arr.tobytes(), read in place (zlib takes the buffer)
    return int(zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(
        np.uint8)))


def _manifest_digest(manifest: Dict[str, Any]) -> str:
    """sha256 over the canonical manifest JSON, digest field excluded."""
    body = {k: v for k, v in manifest.items() if k != "digest"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def _to_numpy(t) -> Tuple[np.ndarray, str]:
    """(array as stored, logical dtype name) of one leaf, contiguous and in
    memory of its own: a device leaf's host copy is that already, a host
    leaf is copied."""
    on_host = t.device.type == "cpu"
    t = t.detach().cpu()
    bf16 = t.dtype == torch.bfloat16
    arr = t.view(torch.int16).numpy().view(np.uint16) if bf16 else t.numpy()
    # .copy(), not np.ascontiguousarray: that turns a 0-d array into (1,)
    if on_host or not arr.flags.c_contiguous:
        arr = arr.copy()
    return arr, _BF16 if bf16 else str(arr.dtype)


def _flatten_with_paths(tree):
    flat, dtypes = {}, {}
    for key, leaf in tree_leaves(tree):
        flat[key], dtypes[key] = _to_numpy(leaf)
    return flat, dtypes


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    # .copy(), not np.ascontiguousarray: that turns a 0-d array into (1,)
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _unflatten_like(template, flat: Dict[str, torch.Tensor], prefix="",
                    shardings=None):
    if isinstance(template, dict):
        return {k: _unflatten_like(
            v, flat, f"{prefix}{_SEP}{k}" if prefix else str(k),
            None if shardings is None else shardings[k])
            for k, v in template.items()}
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    t = flat[prefix]
    if shardings is not None:
        t = shardings.shard(t)
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(
            f"leaf {prefix!r}: checkpoint shape {tuple(t.shape)} != model "
            f"shape {tuple(template.shape)}")
    return t.to(device=template.device, dtype=template.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, config_hash: str = "",
             extra: Optional[Dict[str, Any]] = None,
             background: bool = False) -> str:
        """Snapshot ``tree`` (nested dicts of tensors) at ``step``."""
        self.wait()
        self._clean_stale_tmp()
        # synchronous host snapshot: training may overwrite the tensors next
        flat, dtypes = _flatten_with_paths(tree)
        manifest = {
            "step": int(step),
            "config_hash": config_hash,
            "extra": extra or {},
            "leaves": sorted(flat),
            "dtypes": dtypes,
            "checksums": {k: _crc(v) for k, v in flat.items()},
        }
        manifest["digest"] = _manifest_digest(manifest)
        final = os.path.join(self.dir, f"step_{step:08d}")

        def write():
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)       # atomic publish
            self._gc()

        if background:
            self._thread = threading.Thread(target=self._guard(write),
                                            daemon=True)
            self._thread.start()
        else:
            write()
        return final

    def _guard(self, fn):
        def run():
            try:
                fn()
            except BaseException as e:   # surfaced on next wait()
                self._error = e
        return run

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _clean_stale_tmp(self) -> None:
        """Sweep ``step_*.tmp`` leftovers from a crash between the tmp
        write and ``os.replace``."""
        for d in os.listdir(self.dir):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_verified(self, step: int, verify: bool
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Read and integrity-check one step; raises
        :class:`CheckpointCorruptError` on any damage."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"{d}/manifest.json unreadable: {e}") from e
        digest = manifest.get("digest")
        if verify and digest is not None and \
                _manifest_digest(manifest) != digest:
            raise CheckpointCorruptError(f"{d}: manifest digest mismatch")
        try:
            with np.load(os.path.join(d, "arrays.npz")) as z:
                flat = {k: z[k] for k in z.files}
        except FileNotFoundError:
            raise
        except Exception as e:   # BadZipFile, zlib.error, ValueError, ...
            raise CheckpointCorruptError(
                f"{d}/arrays.npz unreadable: {e}") from e
        sums = manifest.get("checksums")
        if verify and sums is not None:
            missing = set(sums) - set(flat)
            if missing:
                raise CheckpointCorruptError(
                    f"{d}: arrays.npz is missing {sorted(missing)[:3]}...")
            for key, arr in flat.items():
                want = sums.get(key)
                if want is None or _crc(arr) != int(want):
                    raise CheckpointCorruptError(
                        f"{d}: CRC32 mismatch for leaf {key!r}")
        return flat, manifest

    def verify_step(self, step: int) -> bool:
        """True when ``step`` loads and passes its integrity checks."""
        try:
            self._load_verified(step, verify=True)
            return True
        except (CheckpointCorruptError, FileNotFoundError):
            return False

    def restore(self, template: Any, *, step: Optional[int] = None,
                config_hash: str = "", allow_config_change: bool = False,
                shardings=None, verify: bool = True
                ) -> Tuple[Any, Dict[str, Any]]:
        """Load a checkpoint into the structure of ``template`` (nested
        dicts of tensors): each leaf comes back on its template's device
        and in its template's dtype. ``shardings`` (a tree matching
        ``template`` of ``dist.sharding.NamedSharding``) is the elastic
        path, as the reference's: the saved leaves are whole, and each is
        cut to this rank's shard on the current mesh, so a checkpoint
        written on any mesh, or none, restores onto any other. An
        explicit ``step`` that fails verification raises
        :class:`CheckpointCorruptError`; ``step=None``
        walks newest → oldest and restores the newest intact step."""
        if step is None:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            flat = manifest = last_err = None
            for s in reversed(steps):
                try:
                    flat, manifest = self._load_verified(s, verify)
                    break
                except CheckpointCorruptError as e:
                    warnings.warn(f"checkpoint step {s} is corrupt ({e}); "
                                  "falling back to the previous step")
                    last_err = e
            if manifest is None:
                raise CheckpointCorruptError(
                    f"no intact checkpoint in {self.dir} "
                    f"({len(steps)} corrupt)") from last_err
        else:
            flat, manifest = self._load_verified(step, verify)
        if config_hash and manifest["config_hash"] and \
                manifest["config_hash"] != config_hash:
            if not allow_config_change:
                raise ValueError(
                    f"config hash mismatch: ckpt={manifest['config_hash']} "
                    f"vs model={config_hash}")
        dtypes = manifest.get("dtypes", {})
        tensors = {k: _to_tensor(a, dtypes.get(k, str(a.dtype)))
                   for k, a in flat.items()}
        return _unflatten_like(template, tensors, shardings=shardings), \
            manifest


# -- quant artifacts (repro_torch.quant) ---------------------------------------
# A quant artifact is a template-free export: the loader has no calibrated
# consts to init a template from, so the nested trees are rebuilt from the
# "/"-joined keys themselves (both trees are dict-only, so that is exact).
# The format string is versioned so that a stale artifact fails loudly
# instead of mis-dequantizing. File names, keys and the bf16 bit-views are
# the reference's, so each package loads the other's artifact bit for bit.
QUANT_FORMAT = "sltrain-quant-v1"


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key in sorted(flat):
        node = tree
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def save_quant_artifact(directory: str, params: Any, consts: Any, *,
                        config_hash: str = "",
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically export a calibrated (params, consts) pair as a versioned
    int8 serve artifact: ``<directory>/{manifest.json, arrays.npz}``."""
    pflat, pdt = _flatten_with_paths(params)
    cflat, cdt = _flatten_with_paths(consts)
    flat = {**{"params" + _SEP + k: v for k, v in pflat.items()},
            **{"consts" + _SEP + k: v for k, v in cflat.items()}}
    dtypes = {**{"params" + _SEP + k: v for k, v in pdt.items()},
              **{"consts" + _SEP + k: v for k, v in cdt.items()}}
    manifest = {
        "format": QUANT_FORMAT,
        "config_hash": config_hash,
        "extra": extra or {},
        "leaves": sorted(flat),
        "dtypes": dtypes,
    }
    tmp = directory.rstrip(os.sep) + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return directory


def load_quant_artifact(directory: str, device="cuda"
                        ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Load a :func:`save_quant_artifact` export (of either package) onto
    ``device``. Returns (params, consts, manifest) with every leaf
    bit-identical to what was saved, in its saved dtype."""
    device = resolve(device)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt != QUANT_FORMAT:
        raise ValueError(f"unknown quant artifact format {fmt!r} in "
                         f"{directory} (expected {QUANT_FORMAT!r})")
    dtypes = manifest["dtypes"]
    flat = {}
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        for k in z.files:
            arr = z[k]
            flat[k] = _to_tensor(arr, dtypes.get(k, str(arr.dtype))).to(
                device)
    tree = _nest(flat)
    return tree.get("params", {}), tree.get("consts", {}), manifest
