"""CTC dataset readers.

Reference parity: ``DataHandeling.py`` (sic) in arbellea/LSTM-UNet
(SURVEY.md §2 "Training reader"/"Inference reader", §3.4 producer thread):

- ``CTCRAMReaderSequence2D`` — loads whole CTC sequences into RAM, converts
  instance SEG GT → 3-class maps, augments (crop/flip/rot, brightness/contrast
  jitter — sampled once per sequence traversal so LSTM state stays coherent
  across windows), chops into ``unroll_len`` windows, and serves batches from
  producer threads through a bounded queue. Emits per-lane ``is_last`` flags
  marking sequence ends so the trainer can reset LSTM state per lane [M].
- ``CTCInferenceReader`` — globs ``t*.tif`` in a sequence dir and yields
  frames in order, optionally prefixed by reversed warm-up frames [M].

CTC directory layout (behavioral contract, SURVEY.md §8.1):
    <root>/<dataset>/<seq>/t*.tif
    <root>/<dataset>/<seq>_GT/SEG/man_seg*.tif   (possibly sparse)
    <root>/<dataset>/<seq>_ST/SEG/man_seg*.tif   (silver truth, optional)
"""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import CTCParams
from ..utils import log_print
from .preprocess import instance_to_three_class, percentile_normalize_np
from .tiff import read_tiff

_FRAME_RE = re.compile(r"t(\d+)\.tif$")
_SEG_RE = re.compile(r"man_seg(\d+)\.tif$")


def _frame_index(path: str, pattern: re.Pattern) -> Optional[int]:
    m = pattern.search(os.path.basename(path))
    return int(m.group(1)) if m else None


class _SequenceData:
    """One CTC sequence fully resident in RAM (images + 3-class GT + flags)."""

    def __init__(self, images: np.ndarray, seg: np.ndarray, valid: np.ndarray,
                 full_seg: np.ndarray, name: str,
                 inst: Optional[np.ndarray] = None):
        self.images = images      # [T,H,W] float32 (percentile-normalized)
        self.seg = seg            # [T,H,W] uint8 {0,1,2}
        self.valid = valid        # [T] bool — frame has SEG annotation
        self.full_seg = full_seg  # [T] bool — annotation covers every cell
        self.inst = inst          # [T,H,W] int32 instance ids, or None
        self.name = name

    def __len__(self) -> int:
        return self.images.shape[0]


def load_ctc_sequence(root: str, dataset: str, seq: str,
                      gt_is_full_seg: Optional[bool] = None,
                      keep_instances: bool = False) -> _SequenceData:
    """Load one CTC sequence + GT into RAM (reference: RAM reader load [H]).

    ``full_seg`` semantics (reference: DataHandeling.py full_seg flag [M]):
    silver truth (``_ST``) and simulated datasets (name contains "SIM") are
    fully annotated; gold truth (``_GT``) on real datasets may label only
    some cells per frame. ``gt_is_full_seg`` overrides the heuristic.
    ``keep_instances`` additionally keeps the raw instance-labeled GT
    (needed for the per-object SEG validation metric).
    """
    seq_dir = os.path.join(root, dataset, seq)
    frames = sorted(glob.glob(os.path.join(seq_dir, "t*.tif")))
    if not frames:
        raise FileNotFoundError(f"no t*.tif frames under {seq_dir}")
    imgs = np.stack([percentile_normalize_np(read_tiff(p)) for p in frames])

    t, h, w = imgs.shape
    seg = np.zeros((t, h, w), dtype=np.uint8)
    inst = np.zeros((t, h, w), dtype=np.int32) if keep_instances else None
    valid = np.zeros((t,), dtype=bool)
    full = np.zeros((t,), dtype=bool)
    gt_full = gt_is_full_seg if gt_is_full_seg is not None else ("SIM" in dataset)
    for gt_kind, kind_full in (("_GT", gt_full), ("_ST", True)):
        seg_dir = os.path.join(root, dataset, seq + gt_kind, "SEG")
        for p in sorted(glob.glob(os.path.join(seg_dir, "man_seg*.tif"))):
            idx = _frame_index(p, _SEG_RE)
            if idx is None or idx >= t or valid[idx]:
                continue
            raw = read_tiff(p)
            seg[idx] = instance_to_three_class(raw)
            if inst is not None:
                inst[idx] = raw.astype(np.int32)
            valid[idx] = True
            full[idx] = kind_full
    return _SequenceData(imgs, seg, valid, full, f"{dataset}/{seq}", inst)


class CTCRAMReaderSequence2D:
    """Threaded unrolled-batch provider (reference: CTCRAMReaderSequence2D [H]).

    Each of the ``batch_size`` lanes independently walks a randomly chosen
    sequence in ``unroll_len`` windows with per-traversal augmentation;
    ``get_batch()`` returns::

        image [B,T,H,W,1] float32,
        seg   [B,T,H,W]   int32 {0,1,2},
        valid [B,T]       float32 (frame annotated → contributes to loss),
        full_seg [B,T]    float32 (frame fully annotated; partial frames train
                          only on labeled pixels — see engine/loss.py),
        is_last [B]       float32 (window ends its sequence → reset LSTM lane)

    NOTE on threading: the consumer carries LSTM state from batch N into
    batch N+1, so lane i's consecutive windows MUST form one continuous
    stream — independent producers interleaving whole batches on one queue
    would silently break streaming-BPTT continuity (state from thread A
    applied to thread B's windows). Parallelism is therefore PER LANE: each
    batch lane owns a FIFO queue; ``num_threads`` producer threads share the
    lanes round-robin, each lane driven by its own counter-based RNG stream;
    ``get_batch()`` assembles one window from every lane queue. Lane
    continuity holds by construction and the produced stream is BIT-
    IDENTICAL for any thread count (threads only change who computes a
    lane's next window, never its content or order).
    """

    def __init__(self, params: CTCParams, sequence_list: Optional[Sequence] = None,
                 num_threads: Optional[int] = None, queue_capacity: int = 16,
                 seed: int = 0, return_instances: bool = False):
        self.params = params
        self.crop = tuple(params.crop_size)
        self.unroll = params.unroll_len
        self.batch = params.batch_size
        # return_instances: batches gain a 6th element, instance GT
        # [B,T,H,W] int32, augmented in lockstep — feeds the per-object SEG
        # validation metric (SURVEY.md §2 "Validation metric")
        self.return_instances = return_instances
        seq_list = sequence_list if sequence_list is not None else params.train_sequence_list
        gt_full = getattr(params, "gt_is_full_seg", None)
        self.sequences = [
            load_ctc_sequence(params.root_data_dir, ds, sq, gt_full,
                              keep_instances=return_instances)
            for ds, sq in seq_list
        ]
        self.elastic = params.elastic_augmentation
        requested = num_threads if num_threads is not None else params.num_prefetch_threads
        self.num_threads = max(1, min(requested, self.batch))
        # one bounded FIFO per lane (see class docstring threading note)
        cap = max(2, queue_capacity // self.batch)
        self._lane_qs: List[queue.Queue] = [
            queue.Queue(maxsize=cap) for _ in range(self.batch)]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._seed = seed
        self._err: Optional[BaseException] = None
        self.randomize = params.randomize

    # -- per-lane stream ----------------------------------------------------

    def _new_traversal(self, rng: np.random.Generator):
        """Pick a sequence + per-traversal augmentation (SURVEY.md §3.4)."""
        s = self.sequences[rng.integers(len(self.sequences))] if self.randomize else self.sequences[0]
        t, h, w = s.images.shape
        ch, cw = self.crop
        ch, cw = min(ch, h), min(cw, w)
        aug = {
            "y0": int(rng.integers(0, h - ch + 1)) if self.randomize else 0,
            "x0": int(rng.integers(0, w - cw + 1)) if self.randomize else 0,
            "flip_y": bool(rng.integers(2)) and self.randomize,
            "flip_x": bool(rng.integers(2)) and self.randomize,
            "rot90": int(rng.integers(4)) if (self.randomize and ch == cw) else 0,
            "gain": float(rng.uniform(0.9, 1.1)) if self.randomize else 1.0,
            "bias": float(rng.uniform(-0.05, 0.05)) if self.randomize else 0.0,
            "start": 0,
            "affine": None,
        }
        if self.elastic and self.randomize:
            # small affine (rotation/scale/shear), fixed for the whole
            # traversal so LSTM state stays geometrically coherent
            # (reference: elastic/affine augmentation option [M])
            ang = rng.uniform(-10, 10)
            scale = rng.uniform(0.9, 1.1)
            shear = rng.uniform(-0.05, 0.05)
            a = np.deg2rad(ang)
            m = np.array([[np.cos(a) * scale, -np.sin(a) + shear, 0.0],
                          [np.sin(a) + shear, np.cos(a) * scale, 0.0]],
                         np.float32)
            aug["affine"] = m
        return s, aug

    @staticmethod
    def _apply_affine(img: np.ndarray, seg: np.ndarray, m: np.ndarray,
                      inst: Optional[np.ndarray] = None):
        """Affine-warp a [T,H,W] window about its center (image bilinear,
        labels nearest, reflected at the border).

        ``m`` is a 2x3 forward map in (x, y) = (col, row) coordinates;
        scipy pulls each output pixel from ``inverse(m)`` of it in
        (row, col) order.
        """
        from scipy.ndimage import affine_transform

        h, w = img.shape[1:]
        swap = np.array([[0.0, 1.0], [1.0, 0.0]])
        a_rc = swap @ m[:, :2].astype(np.float64) @ swap
        inv = np.linalg.inv(a_rc)
        center = np.array([h / 2, w / 2])
        # rotate/scale about the crop center: src = center + inv (dst - center)
        offset = center - inv @ center

        def warp(frames, order):
            return np.stack([
                affine_transform(f, inv, offset=offset, order=order,
                                 mode="reflect") for f in frames])

        img = warp(img, 1)
        seg = warp(seg, 0)
        if inst is not None:
            inst = warp(inst, 0)
        return img, seg, inst

    def _window(self, s: _SequenceData, aug: Dict, start: int):
        ch, cw = min(self.crop[0], s.images.shape[1]), min(self.crop[1], s.images.shape[2])
        sl_t = slice(start, start + self.unroll)
        sl_y = slice(aug["y0"], aug["y0"] + ch)
        sl_x = slice(aug["x0"], aug["x0"] + cw)
        img = s.images[sl_t, sl_y, sl_x].copy()
        seg = s.seg[sl_t, sl_y, sl_x].astype(np.int32)
        inst = (s.inst[sl_t, sl_y, sl_x].copy()
                if self.return_instances else None)
        valid = s.valid[sl_t].astype(np.float32)
        full_seg = s.full_seg[sl_t].astype(np.float32)
        # pad short tail windows by repeating the last frame; padded frames invalid
        n = img.shape[0]
        if n < self.unroll:
            rep = self.unroll - n
            img = np.concatenate([img, np.repeat(img[-1:], rep, 0)], 0)
            seg = np.concatenate([seg, np.repeat(seg[-1:], rep, 0)], 0)
            if inst is not None:
                inst = np.concatenate([inst, np.repeat(inst[-1:], rep, 0)], 0)
            valid = np.concatenate([valid, np.zeros(rep, np.float32)], 0)
            full_seg = np.concatenate([full_seg, np.zeros(rep, np.float32)], 0)
        labs = [seg] if inst is None else [seg, inst]
        if aug["flip_y"]:
            img = img[:, ::-1]
            labs = [l[:, ::-1] for l in labs]
        if aug["flip_x"]:
            img = img[:, :, ::-1]
            labs = [l[:, :, ::-1] for l in labs]
        if aug["rot90"]:
            img = np.rot90(img, aug["rot90"], axes=(1, 2))
            labs = [np.rot90(l, aug["rot90"], axes=(1, 2)) for l in labs]
        seg = labs[0]
        inst = labs[1] if inst is not None else None
        if aug["affine"] is not None:
            img, seg, inst = self._apply_affine(img, seg, aug["affine"], inst)
        img = img * aug["gain"] + aug["bias"]  # photometric jitter [M]
        is_last = float(start + self.unroll >= len(s))
        return img.astype(np.float32), seg, inst, valid, full_seg, is_last

    def _producer(self, tid: int):
        try:
            self._producer_loop(tid)
        except BaseException as e:
            # propagate to the consumer: a dead producer must not leave
            # get_batch() blocking forever (e.g. a cv2.warpAffine failure);
            # get_batch polls self._err, so setting it is sufficient
            if self._err is None:
                self._err = e

    def _producer_loop(self, tid: int):
        """Produce the window streams of the lanes owned by this thread.

        Lane i's stream is a pure function of (seed, i): its own RNG drives
        sequence choice + augmentation, so output is identical for any
        thread count. Per-lane bounded queues provide back-pressure; a
        thread cycles its lanes so none runs ahead by more than the queue
        capacity.
        """
        my_lanes = [i for i in range(self.batch)
                    if i % self.num_threads == tid]
        rngs = {i: np.random.default_rng(self._seed + 9973 * i)
                for i in my_lanes}
        lanes = {i: self._new_traversal(rngs[i]) for i in my_lanes}
        while not self._stop.is_set():
            for i in my_lanes:
                s, aug = lanes[i]
                img, seg, inst, valid, full_seg, is_last = self._window(
                    s, aug, aug["start"])
                if is_last:
                    lanes[i] = self._new_traversal(rngs[i])
                else:
                    aug["start"] += self.unroll
                item = (img, seg, inst, valid, full_seg, is_last)
                while not self._stop.is_set():
                    try:
                        self._lane_qs[i].put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

    # -- public API (names follow the reference [M]) ------------------------

    def start_queues(self) -> None:
        if self._threads:
            return  # already running
        self._stop.clear()  # reusable after stop()
        for tid in range(self.num_threads):
            th = threading.Thread(target=self._producer, args=(tid,), daemon=True)
            th.start()
            self._threads.append(th)
        log_print(f"CTCRAMReaderSequence2D: {self.num_threads} producer thread(s) started")

    def get_batch(self):
        items = []
        for q in self._lane_qs:
            while True:
                if self._err is not None:
                    raise self._err
                try:
                    items.append(q.get(timeout=0.5))
                    break
                except queue.Empty:
                    continue
        imgs, segs, insts, valids, fulls, lasts = zip(*items)
        batch = (
            np.stack(imgs)[..., None],
            np.stack(segs),
            np.stack(valids),
            np.stack(fulls),
            np.asarray(lasts, np.float32),
        )
        if self.return_instances:
            batch = batch + (np.stack(insts),)
        return batch

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=2.0)
        self._threads.clear()
        # drain leftover windows: a restarted producer begins fresh traversals,
        # so stale mid-sequence windows would pair a fresh LSTM state with the
        # tail of an old stream and break BPTT window continuity
        for q in self._lane_qs:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        self._err = None


class CTCInferenceReader:
    """Frame iterator for streaming inference (reference: CTCInferenceReader [H]).

    Yields (frame_index_or_None, normalized_frame [H,W] float32). Warm-up
    frames (``pre_sequence_frames`` initial frames, reversed) are yielded
    first with index None — their outputs must be discarded but their state
    kept (SURVEY.md §3.2 warm-up [M]).
    """

    def __init__(self, sequence_path: str, filename_format: str = "t*.tif",
                 pre_sequence_frames: int = 0, normalize: bool = True):
        self.paths = sorted(glob.glob(os.path.join(sequence_path, filename_format)))
        if not self.paths:
            raise FileNotFoundError(
                f"no frames matching {filename_format} under {sequence_path}")
        self.pre = min(pre_sequence_frames, len(self.paths))
        # normalize=False leaves frames raw float32 for on-device
        # normalization inside the streaming engine's jitted step
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.paths)

    def frame_indices(self) -> List[int]:
        out = []
        for p in self.paths:
            idx = _frame_index(p, _FRAME_RE)
            out.append(idx if idx is not None else len(out))
        return out

    def _load(self, path: str) -> np.ndarray:
        img = read_tiff(path)
        if self.normalize:
            return percentile_normalize_np(img)
        # raw NATIVE dtype: integer frames stay uint8/uint16 so the engine
        # can upload half-width and use the exact histogram quantile
        return img

    def __iter__(self):
        idxs = self.frame_indices()
        for p in reversed(self.paths[: self.pre]):
            yield None, self._load(p)
        for p, idx in zip(self.paths, idxs):
            yield idx, self._load(p)
