"""Checkpoint/restart for fault tolerance (port of
``repro.checkpoint.manager``).

The on-disk format is the reference's, so checkpoints load in both
directions between ``repro`` and ``repro_torch``:

* **Content**: the state as a flat ``{key: ndarray}`` dict in numpy's npz
  container, keyed as ``jax.tree_util.keystr`` names the reference's leaves
  (``.layers[0].rows``, ``.cascades``, ...), plus a JSON manifest (step,
  extra metadata such as the stream cursor, the sorted keys, the payload's
  byte length ``arrays_bytes`` and CRC32 ``arrays_crc32``).  No pickle.
  bfloat16 leaves are stored as the reference stores them: their raw 2-byte
  words (numpy ``|V2``).  The port walks its own dataclasses (``HierAssoc``,
  ``Assoc``), tuples, lists and dicts to name the leaves.
* **Atomicity**: written to ``<dir>/tmp-<step>-<pid>`` and published with
  ``os.replace`` into ``ckpt-<step>``: a crash mid-write never damages the
  newest published generation.
* **Async**: :meth:`CheckpointManager.save_async` takes owned host copies of
  every tensor before it returns (a copy from the card is ordered after
  every update already queued on the caller's stream, and finished when it
  returns; a CPU tensor is cloned, since the next update overwrites the
  state in place), then serializes on a daemon thread.
* **Retention**: the newest ``keep`` generations, best-effort cleanup.
* **Integrity**: :meth:`CheckpointManager.restore` verifies the manifest's
  byte length and CRC32 and, with ``fallback=True`` (the default when no
  step is pinned), walks back past torn or corrupt generations to the
  newest one that verifies, raising :class:`CheckpointDamaged` only when
  none does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import TYPE_CHECKING, Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.faults import FaultPlan


class CheckpointDamaged(RuntimeError):
    """One specific checkpoint generation failed to verify or load."""


# ---------------------------------------------------------------------------
# leaves, named as jax.tree_util.keystr names the reference's
# ---------------------------------------------------------------------------

def _children(tree) -> Optional[Iterator[Tuple[str, Any]]]:
    """``(key suffix, child)`` pairs of a container, or ``None`` for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ((f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return ((f"[{i}]", x) for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return ((f"[{k!r}]", tree[k]) for k in sorted(tree))
    return None


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf of ``tree``, in field order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for suffix, child in kids:
        yield from leaves(child, prefix + suffix)


def rebuild(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{s[1:]: rebuild(c, fn, prefix + s) for s, c in kids}
        )
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], fn, f"{prefix}[{k!r}]") for k in tree}
    return type(tree)(rebuild(c, fn, prefix + s) for s, c in kids)


def host_copy(x) -> np.ndarray:
    """An owned numpy copy of a leaf, bfloat16 as its raw 2-byte words
    (``|V2``, the reference's npz form).  A CUDA tensor's copy is ordered
    after the work queued on the current stream and finished on return."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep: int = 3,
        faults: "Optional[FaultPlan]" = None,
    ):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if faults is None:
            from repro_torch.faults import FaultPlan as _FP

            faults = _FP.from_env()
        self._faults = faults

    # ------------------------------------------------------------- save
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        """Synchronous atomic save."""
        self._write(step, rebuild(state, lambda _, x: host_copy(x)), extra or {})

    def save_async(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        """Owned host copies now; serialization on a background thread.

        The copies are taken before this returns (ROADMAP C5): a view of
        the live state would be overwritten by the next update, which the
        ``cuda`` engine writes in place, and the serializer would write
        torn state.
        """
        self.wait()  # one outstanding save at a time
        host_state = rebuild(state, lambda _, x: host_copy(x))

        def work():
            try:
                self._write(step, host_state, extra or {})
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def set_faults(self, faults: "Optional[FaultPlan]") -> None:
        """Attach (or clear) a fault plan after construction (the serve
        loop shares its plan with the session's manager)."""
        self._faults = faults

    def _write(self, step: int, host_state, extra: Dict[str, Any]):
        tmp = os.path.join(self.dir, f"tmp-{step}-{os.getpid()}")
        final = os.path.join(self.dir, f"ckpt-{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        flat = {k: np.asarray(v) for k, v in leaves(host_state)}
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **flat)

        with open(npz_path, "rb") as f:
            payload = f.read()
        manifest = {
            "step": step,
            "extra": extra,
            "keys": sorted(flat.keys()),
            "time": time.time(),
            "arrays_bytes": len(payload),
            "arrays_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        }

        # The fault sites damage the payload after the manifest's integrity
        # fields were computed over the good bytes (a disk that lies between
        # write and publish); the publish below still happens.
        if self._faults is not None:
            spec = self._faults.fire("checkpoint.torn_write", cursor=step)
            if spec is not None:
                keep = int(spec.args.get("keep_bytes", len(payload) // 2))
                with open(npz_path, "r+b") as f:
                    f.truncate(max(0, keep))
            spec = self._faults.fire("checkpoint.corrupt_payload", cursor=step)
            if spec is not None:
                off = min(
                    int(spec.args.get("offset", len(payload) // 2)),
                    max(0, len(payload) - 1),
                )
                with open(npz_path, "r+b") as f:
                    f.seek(off)
                    b = f.read(1)
                    f.seek(off)
                    f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"ckpt-{s:09d}"), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt-(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_verified(self, step: int, state_like):
        """Load and check one generation; raises :class:`CheckpointDamaged`
        on whatever a bad disk can produce (torn payload, flipped bytes, an
        unreadable zip, missing keys, a garbled manifest)."""
        path = os.path.join(self.dir, f"ckpt-{step:09d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            npz_path = os.path.join(path, "arrays.npz")
            with open(npz_path, "rb") as f:
                payload = f.read()
            want_bytes = manifest.get("arrays_bytes")
            if want_bytes is not None and len(payload) != want_bytes:
                raise CheckpointDamaged(
                    f"ckpt-{step:09d}: arrays.npz is {len(payload)} bytes, "
                    f"manifest says {want_bytes} (torn write)"
                )
            want_crc = manifest.get("arrays_crc32")
            if want_crc is not None:
                got = zlib.crc32(payload) & 0xFFFFFFFF
                if got != want_crc:
                    raise CheckpointDamaged(
                        f"ckpt-{step:09d}: arrays.npz crc32 {got:#010x} != "
                        f"manifest {want_crc:#010x} (corrupt payload)"
                    )
            arrays = np.load(npz_path)
            state = rebuild(state_like, lambda key, _: np.array(arrays[key], copy=True))
        except CheckpointDamaged:
            raise
        except Exception as err:
            # np.load raises BadZipFile / OSError / KeyError / EOFError
            # depending on where the damage lands: damage of this
            # generation, not a caller bug
            raise CheckpointDamaged(f"ckpt-{step:09d}: {err!r}") from err
        return state, manifest

    def restore(
        self,
        state_like,
        step: Optional[int] = None,
        shardings=None,
        fallback: Optional[bool] = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``state_like``: owned numpy leaves
        as saved (any width; bfloat16 as its ``|V2`` words), which the
        caller places (``D4MStream.restore`` cuts or pads the layers to its
        own widths and moves them to its device).  With ``shardings`` (a
        :class:`repro_torch.core.mesh.NamedSharding`, or a tree of them
        with the state's structure down to them: an elastic restart onto
        another mesh) each leaf comes back placed instead, a
        :class:`~repro_torch.core.mesh.Sharded` whose chunks went from the
        host copy straight to their devices, into buffers of their own.

        ``fallback=True`` walks back past damaged generations to the newest
        one that verifies; ``False`` raises :class:`CheckpointDamaged` on
        the requested one.  Default: fall back exactly when no ``step`` was
        pinned.
        """
        if fallback is None:
            fallback = step is None
        steps = self.all_steps()
        if step is not None:
            candidates = [s for s in steps if s <= step]
            if step not in steps:
                raise FileNotFoundError(f"no checkpoint for step {step} in {self.dir}")
        else:
            candidates = steps
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")

        last_err: Optional[CheckpointDamaged] = None
        for s in reversed(candidates):
            try:
                state, manifest = self._load_verified(s, state_like)
            except CheckpointDamaged as err:
                last_err = err
                if not fallback:
                    raise
                continue
            if shardings is not None:
                from repro_torch.core.mesh import device_put

                state = device_put(state, shardings, copy=True)
            return state, manifest["extra"] | {"step": manifest["step"]}
        raise CheckpointDamaged(
            f"all {len(candidates)} checkpoint generation(s) in {self.dir} "
            f"are damaged; last error: {last_err}"
        )
