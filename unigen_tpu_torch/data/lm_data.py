"""Language-modeling text stream from parquet files.

The port's copy of ``unigen_tpu/data/lm_data.py`` (the reference's
training/data_loader.py:406-513, ParquetTextDataset +
make_pretrain_lm_dataloader): RefinedWeb-style parquet rows, a random
``max_length``-character crop per row (:438-453), rows sharded by process,
raw strings out (tokenization happens in prompting's 'lm' task). Reading
parquet needs pyarrow, imported at the first row; where it is missing the
stream raises ``ImportError`` naming it (the card's machine has none).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Sequence


def _parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("ParquetTextDataset reads parquet through pyarrow, which this "
                          f"machine lacks ({e})") from e
    return pq


@dataclass
class ParquetTextDataset:
    files: Sequence[str]
    per_device_batch_size: int
    max_length_chars: int = 2048           # character budget before tokenize
    content_column: str = "content"
    subsample: float = 1.0                 # reference train_lm_subsample
    process_index: int = 0
    process_count: int = 1
    seed: int = 0

    def __post_init__(self):
        if not self.files:
            raise ValueError("no parquet files")
        self._rng = random.Random(self.seed + self.process_index)

    def _rows(self) -> Iterator[str]:
        pq = _parquet()
        files = list(self.files)
        while True:
            self._rng.shuffle(files)
            for path in files:
                try:
                    table = pq.read_table(path, columns=[self.content_column])
                except Exception:
                    continue
                col = table.column(self.content_column).to_pylist()
                # distributed row sharding (reference DistributedSampler, :455-479)
                for i in range(self.process_index, len(col), self.process_count):
                    text = col[i]
                    if not text:
                        continue
                    if self.subsample < 1.0 and self._rng.random() > self.subsample:
                        continue
                    yield text

    def _crop(self, text: str) -> str:
        """Random max_length-char window (reference :438-453)."""
        if len(text) <= self.max_length_chars:
            return text
        start = self._rng.randint(0, len(text) - self.max_length_chars)
        return text[start:start + self.max_length_chars]

    def __iter__(self) -> Iterator[dict]:
        batch: List[str] = []
        for text in self._rows():
            batch.append(self._crop(text))
            if len(batch) == self.per_device_batch_size:
                yield {"input_ids": batch}
                batch = []
