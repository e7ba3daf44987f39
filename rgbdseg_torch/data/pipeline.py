"""Dataset and fixed-shape padded batching (counterpart of
`rgbdseg_tpu/data/pipeline.py`: `Batch`, `compact_targets`, `load_meta`,
`get_label2id`, `SegmentationDataset`, `build_datasets`).

- meta-JSON records are processed by the version's channel builder
  (`data/registry.py`), or shipped as packed raw uint8 frames that the train
  and eval steps build into the stack on the device (`device_channels`);
- variable-count instance masks are padded to `max_instances` with a validity
  mask (static shapes through the matcher, the losses and eval);
- batches are assembled by a double-buffered thread pool while the device
  computes. The map functions run torch CPU ops (the exact resizers) in those
  threads, each with torch's intra-op pool; `chip_smoke.py` phase 15 times the
  loading with torch's default pool and with one thread per worker, and
  neither was faster on both of two H100 hosts (PERF.md §5), so nothing sets
  the pool's size.

Meta JSON schema (reference: dataset/local/experiment_tiny_set/train.json,
architecture_change.md:185-200):
  [{"image": path or [rgb, depth, ...], "annotation": mask.png,
    "semantic_class_to_id": {...}}, ...]
"""

from __future__ import annotations

import concurrent.futures as futures
import json
import logging
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..config import PreprocessConfig
from ..versions import get as get_version
from . import device_preprocess as DP
from . import image_io
from . import registry as R

logger = logging.getLogger(__name__)


@dataclass
class Batch:
    # (B, H, W, C) float32 channel stack, or (B, H, W, packed_width) raw uint8
    # frames that `device_preprocess.build_from_packed` turns into it
    pixel_values: np.ndarray
    mask_labels: np.ndarray  # (B, T, H', W') float32 0/1, padded to T instances
    class_labels: np.ndarray  # (B, T) int
    valid: np.ndarray  # (B, T) bool: which of the T slots are real instances
    # per-example original (pre-resize) image sizes (B, 2) int32, for eval at
    # the original size (reference: predictor.py:692-703)
    orig_sizes: Optional[np.ndarray] = None
    # the masks bit-packed, (B, T, ceil(H'*W'/8)) uint8 (np.packbits over the
    # flattened (H', W')): shipped to the device instead of mask_labels
    mask_labels_packed: Optional[np.ndarray] = None


def compact_targets(
    mask_labels: np.ndarray,
    class_labels: np.ndarray,
    valid: np.ndarray,
    min_bucket: int = 8,
    packed: Optional[np.ndarray] = None,
) -> tuple:
    """Slice padded instance targets to the smallest power-of-two bucket
    (at least `min_bucket`) covering the batch's most real instances.

    The criterion's cost is linear in the padded slot count T, and every
    padded slot pays full price. Valid slots are moved first (a stable
    valid-first permutation, applied only when a valid slot lies past the
    slice point), then every target array is sliced to the bucket. Padding
    rows enter the matcher with a uniform cost and the losses only through
    no-object labels, so the loss is unchanged except that the criterion's
    point coordinates are drawn for T_bucket slots instead of T.

    `packed`, the bit-packed (B, T, N) twin of the masks, is permuted and
    sliced identically and returned as a 4th element.
    """
    valid = np.asarray(valid, bool)
    t = valid.shape[1]
    tmax = int(valid.sum(1).max(initial=0))
    tb = max(1, int(min_bucket))
    while tb < tmax:
        tb *= 2
    tb = min(tb, t)
    if tb >= t:
        out = (mask_labels, class_labels, valid)
        return out + (packed,) if packed is not None else out
    if valid[:, tb:].any():  # valid slots past the slice point: pack them first
        order = np.argsort(~valid, axis=1, kind="stable")
        mask_labels = np.take_along_axis(mask_labels, order[:, :, None, None], axis=1)
        class_labels = np.take_along_axis(class_labels, order, axis=1)
        if packed is not None:
            packed = np.take_along_axis(packed, order[:, :, None], axis=1)
        valid = np.take_along_axis(valid, order, axis=1)
    out = (mask_labels[:, :tb], class_labels[:, :tb], valid[:, :tb])
    return out + (packed[:, :tb],) if packed is not None else out


def load_meta(path: str, root: Optional[str] = None) -> list[dict]:
    with open(path) as f:
        records = json.load(f)
    if root:
        for r in records:
            img = r["image"]
            r["image"] = (
                [os.path.join(root, p) for p in img] if isinstance(img, list) else os.path.join(root, img)
            )
            r["annotation"] = os.path.join(root, r["annotation"])
    return records


def get_label2id(path: str) -> dict[str, int]:
    with open(path) as f:
        return json.load(f)


def _frame_size(frame) -> tuple[int, int]:
    """(height, width) of a frame: a PNG's header, or an array's shape."""
    if isinstance(frame, str):
        return image_io.png_size(frame)
    h, w = np.asarray(frame).shape[:2]
    return int(h), int(w)


class SegmentationDataset:
    """Deterministic, indexable dataset producing fixed-shape examples."""

    def __init__(
        self,
        records: list[dict],
        version: str,
        preprocess: PreprocessConfig,
        max_instances: int = 20,
        cache: bool = True,
        cache_bytes_limit: int = 4 << 30,
        device_channels: bool = False,
    ):
        """`device_channels=True` makes examples carry packed raw uint8 frames
        (rgb | depth [| gradient], 6-9 bytes per pixel) instead of the built
        float32 channel stack; the train and eval steps then build the
        channels on the device (`device_preprocess.build_from_packed`, exact
        to the host builders). The mode is decided up front from header-only
        size reads and turns itself off for the whole dataset when an example
        is ineligible (a layout built on the host only, such as the 10-frame
        records of `map_30channel`, an augmentation transform, or frames of
        more than one size), so one batch never mixes the two layouts."""
        self.records = records
        self.version = version
        self.preprocess = preprocess
        self.max_instances = max_instances
        self.device_channels = device_channels and self._probe_device_channels()
        self.map_fn = R.MAP_FUNCTIONS[get_version(version).map_fn]
        # Processed examples are cached on first access, up to `cache_bytes_limit`
        # (the reference materialises them once through datasets.map).
        self._cache: Optional[dict[int, tuple]] = {} if cache else None
        self._cache_bytes = 0
        self._cache_bytes_limit = cache_bytes_limit
        self._warned_truncation = False
        # Set by the trainer's loops: batches carry the bit-packed GT masks,
        # built in the worker threads and memoised with the cached item.
        self.pack_gt = False
        self._packed_cache: dict[int, np.ndarray] = {}
        self._orig_sizes: dict[int, tuple[int, int]] = {}

    def __len__(self) -> int:
        return len(self.records)

    def original_size(self, idx: int) -> tuple[int, int]:
        """(height, width) of the raw (pre-resize) RGB image: a header-only read,
        cached. Reference: get_original_image_sizes_from_image_list (predictor.py:692)."""
        if idx not in self._orig_sizes:
            img = self.records[idx]["image"]
            self._orig_sizes[idx] = _frame_size(img[0] if isinstance(img, (list, tuple)) else img)
        return self._orig_sizes[idx]

    def original_rgb(self, idx: int) -> np.ndarray:
        """Raw RGB image at its original size (for original-size overlays)."""
        img = self.records[idx]["image"]
        img = img[0] if isinstance(img, (list, tuple)) else img
        return image_io.load_rgb(img) if isinstance(img, str) else np.asarray(img)

    def _probe_device_channels(self) -> bool:
        """True iff every example can ship packed raw frames: a supported layout,
        no augmentation transform, and one frame size across the dataset (header
        reads only). The size need not be the target size: the device builder
        resizes with the host resamplers' exact twins; one size keeps the packed
        batches to one shape. The packed frames are 8-bit, so a 16-bit frame
        sends the dataset to the host builders, which read it as PIL does."""
        spec = get_version(self.version)
        if not DP.supported(spec.map_fn) or R.TRANSFORM is not None:
            return False
        n_frames = DP.packed_width(spec.map_fn) // 3
        sizes = set()
        for rec in self.records:
            imgs = rec["image"] if isinstance(rec["image"], (list, tuple)) else [rec["image"]]
            if len(imgs) < n_frames:
                return False
            for p in imgs[:n_frames]:
                if isinstance(p, str) and image_io.png_header(p)[2] != 8:
                    return False
                sizes.add(_frame_size(p))
                if len(sizes) > 1:
                    return False
        return True

    def _raw_item(self, idx: int):
        """Packed raw uint8 frames and host-built labels (eligibility already
        established by `_probe_device_channels`)."""
        spec = get_version(self.version)
        example = self.records[idx]
        color, mask = R._color_and_mask(example)
        frames = [color]
        width = DP.packed_width(spec.map_fn)
        if width > 3:
            frames.append(R._depth_rgb(example["image"]))
        if width > 6:
            frames.append(R._depth_rgb(example["image"], 2))
        instance_map, mapping = R._mask_and_mapping(mask)
        masks, labels = R._labels(instance_map, mapping, self.preprocess)
        return np.concatenate(frames, axis=-1), masks, labels

    def __getitem__(self, idx: int):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        raw = None
        if self.device_channels:
            if R.TRANSFORM is not None:
                # a transform installed after construction: raw frames would skip
                # it, so the host builds the channels from here on (and the cached
                # raw items go, so batches keep one layout)
                logger.warning("device_channels disabled: an augmentation transform was installed; host "
                               "channel building takes over")
                self.device_channels = False
                self._cache = {} if self._cache is not None else None
                self._cache_bytes = 0
            else:
                raw = self._raw_item(idx)
        if raw is not None:
            pix, masks, labels = raw
        else:
            pix, masks, labels = self.map_fn(self.records[idx], self.preprocess)
        t = self.max_instances
        n = min(masks.shape[0], t)
        if masks.shape[0] > t and not self._warned_truncation:
            # The reference keeps ragged instance lists and never drops GT
            # (dataloader.py:772-780); the static padding must not do so silently.
            self._warned_truncation = True
            logger.warning(
                "example %d has %d instances but max_instances=%d — %d GT instance(s) TRUNCATED (raise "
                "max_instances; this warning prints once per dataset)",
                idx, masks.shape[0], t, masks.shape[0] - t,
            )
        # The label geometry comes from the masks (built at the target size), not
        # from pix, which is the raw frame at its own size under device_channels.
        h, w = masks.shape[-2:] if masks.ndim == 3 else pix.shape[:2]
        pm = np.zeros((t, h, w), np.float32)
        pc = np.zeros((t,), np.int32)
        pv = np.zeros((t,), bool)
        pm[:n] = masks[:n]
        pc[:n] = labels[:n]
        pv[:n] = True
        item = (pix if raw is not None else pix.astype(np.float32), pm, pc, pv)
        if self._cache is not None and self._cache_bytes < self._cache_bytes_limit:
            self._cache[idx] = item
            self._cache_bytes += sum(a.nbytes for a in item)
        return item

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 4,
        epoch: int = 0,
        local_rows: Optional[tuple[int, int]] = None,
    ) -> Iterator[Batch]:
        """Yield fixed-shape batches in a deterministic order (shuffled by
        `RandomState(seed + epoch)`); the last partial batch is padded by
        repeating the order's first examples. `local_rows=(start, stop)`
        assembles only that row block of every batch."""
        order = np.arange(len(self))
        if shuffle:
            order = np.random.RandomState(seed + epoch).permutation(order)
        idx_batches = []
        for s in range(0, len(order), batch_size):
            chunk = order[s : s + batch_size]
            if len(chunk) < batch_size:
                if drop_last:
                    continue
                chunk = np.concatenate([chunk, order[: batch_size - len(chunk)]])
            if local_rows is not None:
                chunk = chunk[local_rows[0] : local_rows[1]]
            idx_batches.append(chunk)

        # num_workers=0 (load in the calling process, as HF) takes one worker
        # thread: the order is the same either way.
        with futures.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            pending = []
            it = iter(idx_batches)

            def submit_next():
                try:
                    chunk = next(it)
                except StopIteration:
                    return None
                return pool.submit(self._assemble, chunk)

            for _ in range(2):  # double-buffer
                f = submit_next()
                if f:
                    pending.append(f)
            while pending:
                f = pending.pop(0)
                nxt = submit_next()
                if nxt:
                    pending.append(nxt)
                yield f.result()

    def _packed_masks(self, idx: int, pm: np.ndarray) -> np.ndarray:
        """Bit-packed (T, ceil(H*W/8)) GT of example `idx`, as np.packbits of the
        flattened masks. Memoised only while the item itself is cached, so the
        two caches stay consistent and within one budget."""
        if self._cache is not None and idx in self._cache:
            if idx not in self._packed_cache:
                self._packed_cache[idx] = np.packbits(pm.astype(bool).reshape(pm.shape[0], -1), axis=-1)
            return self._packed_cache[idx]
        return np.packbits(pm.astype(bool).reshape(pm.shape[0], -1), axis=-1)

    def _assemble(self, indices) -> Batch:
        items = [self[int(i)] for i in indices]
        return Batch(
            pixel_values=np.stack([i[0] for i in items]),
            mask_labels=np.stack([i[1] for i in items]),
            class_labels=np.stack([i[2] for i in items]),
            valid=np.stack([i[3] for i in items]),
            orig_sizes=np.array([self.original_size(int(i)) for i in indices], np.int32),
            mask_labels_packed=(
                np.stack([self._packed_masks(int(i), it[1]) for i, it in zip(indices, items)])
                if self.pack_gt
                else None
            ),
        )


def build_datasets(args) -> tuple[SegmentationDataset, SegmentationDataset, dict, dict]:
    """Reference `dataloader(args, ...)` equivalent (dataloader.py:540-565):
    returns (train, valid, label2id, id2label) honouring do_reduce_labels."""
    label2id = get_label2id(os.path.join(args.root_path, args.label2id_path))
    if args.do_reduce_labels:
        label2id = {k: v - 1 for k, v in label2id.items() if v != 0}
    id2label = {v: k for k, v in label2id.items()}

    pp = PreprocessConfig(
        height=args.image_height,
        width=args.image_width,
        do_reduce_labels=args.do_reduce_labels,
        ignore_index=args.ignore_index,
    )
    device_channels = bool(getattr(args, "device_channels", False))
    train = SegmentationDataset(
        load_meta(os.path.join(args.root_path, args.train_json_path), args.root_path),
        args.version, pp, max_instances=args.max_instances, device_channels=device_channels,
    )
    valid = SegmentationDataset(
        load_meta(os.path.join(args.root_path, args.valid_json_path), args.root_path),
        args.version, pp, max_instances=args.max_instances, device_channels=device_channels,
    )
    return train, valid, label2id, id2label
