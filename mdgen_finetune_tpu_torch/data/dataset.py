"""Host-side dataset: CSV splits + atom14 .npy memmaps -> raw window batches.

Counterpart of the JAX package's ``data/dataset.py`` (:26-139; reference
src/mdgen/dataset.py:11-124), in numpy: the host does only IO and window
selection, and the geometry runs on the device through
``featurize.featurize_atom14_batch``. The .npy format is unchanged:
(T, L, 14, 3) float16 memmaps in Angstroms, one file per peptide (plus
_R{1,2,3} replicas for ATLAS). A background thread keeps ``prefetch``
batches ahead of the device.
"""
from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..config import MDGenConfig
from ..geometry import tables as rc


class MDGenDataset:
    def __init__(self, cfg: MDGenConfig, split: str, data_dir: Optional[str] = None,
                 peptide: Optional[str] = None, repeat: int = 1):
        """``repeat`` multiplies the epoch length (each pass re-crops
        randomly, src/mdgen/dataset.py)."""
        self.cfg = cfg
        self.data = cfg.data
        self.repeat = repeat
        self.data_dir = data_dir or cfg.data.data_dir
        with open(split) as f:
            rows = list(csv.DictReader(f))
        self.entries = [(row["name"], row["seqres"]) for row in rows
                        if (peptide is None or row["name"] == peptide) and self._exists(row["name"])]
        if not self.entries:
            raise FileNotFoundError(f"no usable peptides from {split} in {self.data_dir}")

    def _path(self, full_name: str) -> str:
        return os.path.join(self.data_dir, f"{full_name}{self.data.suffix}.npy")

    def _exists(self, name: str) -> bool:
        if self.data.atlas:
            return any(os.path.exists(self._path(f"{name}_R{i}")) for i in (1, 2, 3))
        return os.path.exists(self._path(name))

    def __len__(self) -> int:
        return len(self.entries) * self.repeat

    def sample(self, rng: np.random.Generator, idx: Optional[int] = None) -> dict:
        """One raw example: atom14 (T, crop, 14, 3) f32, seqres (crop,), mask (crop,)."""
        d = self.data
        if d.overfit or idx is None:
            idx = 0 if d.overfit else int(rng.integers(len(self.entries)))
        name, seqres = self.entries[idx % len(self.entries)]
        if d.overfit_peptide:
            name = seqres = d.overfit_peptide

        full_name = name
        if d.atlas:
            while True:
                full_name = f"{name}_R{int(rng.integers(1, 4))}"
                if os.path.exists(self._path(full_name)):
                    break

        arr = np.lib.format.open_memmap(self._path(full_name), mode="r")
        if d.frame_interval:
            arr = arr[:: d.frame_interval]
        start = 0 if d.overfit_frame else int(rng.integers(max(arr.shape[0] - d.num_frames, 1)))
        window = np.array(arr[start:start + d.num_frames], dtype=np.float32)
        if window.shape[0] < d.num_frames:  # short trajectory: repeat the last frame
            pad = np.repeat(window[-1:], d.num_frames - window.shape[0], axis=0)
            window = np.concatenate([window, pad], axis=0)
        if d.copy_frames:
            window[1:] = window[0]

        aatype = rc.str_sequence_to_aatype(seqres)
        L = window.shape[1]
        mask = np.ones(L, dtype=np.float32)
        if d.atlas:
            crop = d.crop
            if L > crop:
                s = int(rng.integers(0, L - crop + 1))
                window, aatype, mask = window[:, s:s + crop], aatype[s:s + crop], mask[s:s + crop]
            elif L < crop:
                pad = crop - L
                window = np.pad(window, [(0, 0), (0, pad), (0, 0), (0, 0)])
                aatype = np.pad(aatype, (0, pad))
                mask = np.pad(mask, (0, pad))
        return {"name": full_name, "frame_start": start, "atom14": window, "seqres": aatype,
                "mask": mask}

    def batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        samples = [self.sample(rng) for _ in range(batch_size)]
        return {
            "atom14": np.stack([s["atom14"] for s in samples]),
            "seqres": np.stack([s["seqres"] for s in samples]),
            "mask": np.stack([s["mask"] for s in samples]),
            "name": [s["name"] for s in samples],
        }


def make_batch_iterator(dataset: MDGenDataset, batch_size: int, seed: int = 0,
                        prefetch: int = 2) -> Iterator[dict]:
    """Endless prefetching iterator over random batches; closing the
    generator stops its worker thread."""
    rng = np.random.default_rng(seed)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                q.put(dataset.batch(rng, batch_size), timeout=1.0)
            except queue.Full:
                continue

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()

    def gen():
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    return gen()
