"""Checkpointing: numpy ``.npz`` archives with a JSON manifest.

Reference parity (SURVEY.md §5 "Checkpoint / resume"): the reference uses
``tf.train.Checkpoint`` (net + optimizer + step) with a ``CheckpointManager``
(max_to_keep) and pickles the architecture params next to the weights so
``Inference2D.py`` can rebuild the model without the training code.

Here: one directory per step, ``<dir>/<step>/``, holding ``params.npz``
(and ``opt_state.npz`` for training saves) plus ``manifest.json``. Each
archive stores the flattened leaves of one pytree keyed by their tree path
(``encoder/0/lstm/0/kernel_x``); the manifest records each leaf's dtype, so
types numpy cannot name in an ``.npz`` (bfloat16) round-trip as raw bits.
A step is written under a hidden partial name and renamed into place, so a
reader never sees half a checkpoint. The architecture goes to a JSON file
(``model_params.json``) instead of a pickle — no arbitrary-code
deserialization.

Saves are asynchronous: :meth:`CheckpointManager.save` copies the trees to
host memory before it returns (so the caller may donate the device buffers
to its next step at once) and a single writer thread writes them to disk.
Restoring and averaging need only numpy; restore places leaves on the
default device.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MODEL_PARAMS_FILE = "model_params.json"
MANIFEST_FILE = "manifest.json"


def resolve_model_dir(directory: str) -> str:
    """Accept a model dir OR the training RUN dir that nests it.

    The Trainer writes ``<run>/ckpt/{model_params.json, <step>/...}``; CLI
    users naturally pass the run dir itself. When ``model_params.json`` is
    absent at ``directory`` but present under its ``ckpt/`` subdir, resolve
    to that subdir; otherwise return the input unchanged (so error messages
    still point at what the user typed).
    """
    if not os.path.exists(os.path.join(directory, MODEL_PARAMS_FILE)):
        sub = os.path.join(directory, "ckpt")
        if os.path.exists(os.path.join(sub, MODEL_PARAMS_FILE)):
            return sub
    return directory


def save_model_params(directory: str, arch: Dict[str, Any]) -> None:
    """Save the architecture/config description (reference: pickled params [M])."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, MODEL_PARAMS_FILE), "w") as f:
        json.dump(arch, f, indent=2)


def load_model_params(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, MODEL_PARAMS_FILE)) as f:
        return json.load(f)


def _key_name(entry) -> str:
    for attr in ("key", "idx", "name"):  # DictKey, SequenceKey, GetAttrKey
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unsupported pytree key {entry!r}")


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """Pytree -> {"a/0/b": host array} (device arrays are copied to host)."""
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    out: Dict[str, np.ndarray] = {}
    for path, leaf in leaves:
        key = "/".join(_key_name(e) for e in path)
        if key in out:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        out[key] = np.asarray(jax.device_get(leaf))
    return out


def _dtype(name: str) -> np.dtype:
    import ml_dtypes  # bfloat16 and friends; ships with jax

    return np.dtype(getattr(ml_dtypes, name, name))


def _write_step(directory: str, step: int,
                items: Dict[str, Dict[str, np.ndarray]]) -> None:
    final = os.path.join(directory, str(step))
    partial = os.path.join(directory, f".{step}.partial")
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)
    manifest: Dict[str, Any] = {"step": step, "items": {}}
    for name, flat in items.items():
        stored, meta = {}, {}
        for key, arr in flat.items():
            meta[key] = {"dtype": arr.dtype.name, "shape": list(arr.shape)}
            # numpy cannot name extension dtypes in an .npz: store the bits
            stored[key] = (arr.view(f"u{arr.dtype.itemsize}")
                           if arr.dtype.kind == "V" else arr)
        with open(os.path.join(partial, f"{name}.npz"), "wb") as f:
            np.savez(f, **stored)
        manifest["items"][name] = meta
    with open(os.path.join(partial, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(partial, final)


def _read_item(directory: str, step: int, name: str) -> Dict[str, np.ndarray]:
    d = os.path.join(directory, str(step))
    with open(os.path.join(d, MANIFEST_FILE)) as f:
        meta = json.load(f)["items"]
    if name not in meta:
        raise KeyError(f"checkpoint step {step} under {directory} has no "
                       f"{name!r} (has {sorted(meta)})")
    out = {}
    with np.load(os.path.join(d, f"{name}.npz")) as z:
        for key, m in meta[name].items():
            arr = z[key]
            dt = _dtype(m["dtype"])
            if arr.dtype != dt:
                arr = arr.view(dt)
            out[key] = arr.reshape(m["shape"])
    return out


def _unflatten_onto(abstract, flat: Dict[str, np.ndarray], what: str):
    """Fill ``abstract``'s structure with ``flat`` leaves (as device arrays
    of the abstract dtype); shapes must match exactly."""
    import jax
    import jax.numpy as jnp

    paths, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    leaves = []
    for path, ref in paths:
        key = "/".join(_key_name(e) for e in path)
        if key not in flat:
            raise KeyError(f"{what}: checkpoint has no leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: leaf {key!r} has shape {arr.shape}, "
                             f"expected {tuple(ref.shape)}")
        leaves.append(jnp.asarray(arr, dtype=ref.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class CheckpointManager:
    """Save/restore {params, opt_state} per step, keeping ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[concurrent.futures.Future] = []

    def save(self, step: int, params, opt_state=None) -> None:
        """Copy both trees to host now; write them on the writer thread.
        ``opt_state=None`` writes a params-only checkpoint."""
        items = {"params": flatten_tree(params)}
        if opt_state is not None:
            items["opt_state"] = flatten_tree(opt_state)
        self._pending.append(self._pool.submit(self._write, int(step), items))

    def _write(self, step: int, items) -> None:
        _write_step(self.directory, step, items)
        if self.max_to_keep and self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def wait(self) -> None:
        """Block until every queued save is on disk; re-raise the first
        write error."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def all_steps(self) -> List[int]:
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.exists(
                os.path.join(self.directory, d, MANIFEST_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return step

    def restore(self, abstract_params, abstract_opt_state,
                step: Optional[int] = None) -> Tuple[Any, Any, int]:
        step = self._resolve(step)
        params = _unflatten_onto(
            abstract_params, _read_item(self.directory, step, "params"),
            "params")
        opt_state = _unflatten_onto(
            abstract_opt_state, _read_item(self.directory, step, "opt_state"),
            "opt_state")
        return params, opt_state, step

    def restore_params_only(self, abstract_params=None,
                            step: Optional[int] = None):
        """Params onto ``abstract_params``'s structure, or the flat
        ``{path: array}`` dict when no structure is given."""
        step = self._resolve(step)
        flat = _read_item(self.directory, step, "params")
        if abstract_params is None:
            return flat
        return _unflatten_onto(abstract_params, flat, "params")

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def average_checkpoints(src_dir: str, out_dir: str,
                        steps=None, out_step: Optional[int] = None) -> int:
    """Checkpoint averaging ("model soup") into a fresh inference model dir.

    Uniform parameter-space average over ``steps`` (default: every step saved
    under ``src_dir``), accumulated in float32 and cast back to each leaf's
    original dtype. The result is written to ``out_dir`` as a *params-only*
    checkpoint at ``out_step`` (default: max of the averaged steps) with
    ``model_params.json`` copied alongside, so the standard
    ``engine.infer.load_model`` path loads it unchanged. The training dir is
    never touched (a soup step saved in-place would evict real checkpoints
    via max_to_keep), and optimizer state is deliberately not averaged —
    soups are an inference-time artifact. ``act_scales.json`` is NOT copied:
    averaged weights shift activation ranges, so the int8 path must be
    recalibrated (the step-stamped provenance guard would reject stale
    scales anyway). Numpy only: it never touches an accelerator.

    Beyond-reference capability: the reference keeps max_to_keep TF
    checkpoints (SURVEY.md §5) but has no averaging; standard practice in
    production serving stacks since late-epoch SGD iterates are cheap
    variance reduction.
    """
    src_dir = resolve_model_dir(src_dir)
    src = CheckpointManager(src_dir)
    try:
        steps = sorted(int(s) for s in (steps or src.all_steps()))
    finally:
        src.close()
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {src_dir}")
    acc: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, np.dtype] = {}
    for s in steps:
        flat = _read_item(src_dir, s, "params")
        if not acc:
            dtypes = {k: v.dtype for k, v in flat.items()}
            acc = {k: v.astype(np.float32) for k, v in flat.items()}
            continue
        if set(flat) != set(acc):
            raise ValueError(
                f"step {s} param tree differs from step {steps[0]}")
        for k, v in flat.items():
            acc[k] += v.astype(np.float32)
    inv = 1.0 / float(len(steps))
    avg = {k: (a * inv).astype(dtypes[k]) for k, a in acc.items()}

    os.makedirs(out_dir, exist_ok=True)
    arch_src = os.path.join(src_dir, MODEL_PARAMS_FILE)
    if os.path.exists(arch_src):
        save_model_params(out_dir, load_model_params(src_dir))
    out_step = out_step if out_step is not None else max(steps)
    _write_step(os.path.abspath(out_dir), out_step, {"params": avg})
    return out_step
