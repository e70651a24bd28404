"""Training data for the PyTorch port: the synthetic source at dp = 1.

Port of ``picotron_tpu/data.py``: ``synthetic_corpus`` (:30), ``_pack``
(:58) and ``MicroBatchDataLoader`` (:98) for ``dataset.name ==
"synthetic"``. The corpus is the JAX package's numpy path, draw for draw,
so the batches are the same bit for bit as the JAX loader's (whose native
recurrence is pinned bitwise to that numpy path). The recurrence is
sequential: about a second of host time for the 2 M-token corpus, once.
HF datasets are not ported (``Config.check_trainable`` refuses them).
A resumed run positions the loader with ``skip_steps`` after
``verify_resume`` has checked the checkpoint's ``state_meta`` (after
``picotron_tpu/data.py:212-264``).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from picotron_tpu_torch.config import Config


def synthetic_corpus(vocab_size: int, length: int, seed: int) -> np.ndarray:
    """Deterministic, learnable token stream: a noisy affine bigram chain
    (next = a*t + b mod V, with a random jump at 5 % of positions), so
    loss falls measurably below ln(V) once a model learns it."""
    rng = np.random.default_rng(seed)
    a = int(rng.integers(1, vocab_size))
    b = int(rng.integers(0, vocab_size))
    toks = np.empty(length, dtype=np.int32)
    toks[0] = rng.integers(0, vocab_size)
    jumps = rng.random(length) < 0.05
    # int64 draws (numpy's default): Generator.integers consumes a
    # different stream per dtype, and the corpus is the JAX package's
    jump_vals = rng.integers(0, vocab_size, length)
    t = int(toks[0])
    for i in range(1, length):
        t = int(jump_vals[i]) if jumps[i] else (a * t + b) % vocab_size
        toks[i] = t
    return toks


def _pack(stream: np.ndarray, chunk: int) -> np.ndarray:
    n = len(stream) // chunk
    return stream[: n * chunk].reshape(n, chunk)


class MicroBatchDataLoader:
    """Yields {'input_ids', 'target_ids'}: int32 [grad_acc, mbs, seq_length]
    numpy arrays of consecutive packed samples, wrapping epochs."""

    def __init__(self, cfg: Config):
        t = cfg.training
        if cfg.dataset.name != "synthetic":
            raise ValueError(
                f"dataset.name={cfg.dataset.name!r}: HF datasets are not in "
                f"the PyTorch port yet (it trains on 'synthetic' only)")
        if cfg.distributed.dp_size != 1:
            raise ValueError("the PyTorch port's loader serves dp = 1 only")
        self.seq_length = t.seq_length
        self.micro_batch_size = t.micro_batch_size
        self.grad_acc = t.gradient_accumulation_steps
        self.rows_per_step = t.micro_batch_size
        stream = synthetic_corpus(
            cfg.model.vocab_size,
            max(2_000_000, 64 * self.rows_per_step * (t.seq_length + 1)),
            t.seed)
        # [n, seq_length + 1] rows, so input and target are shifted views
        self.samples = _pack(stream, self.seq_length + 1)
        if t.num_samples:
            self.samples = self.samples[: t.num_samples]
        if len(self.samples) < self.rows_per_step:
            raise ValueError("dataset too small for one global batch")
        self._epoch = 0
        self._cursor = 0
        self._batch_offsets = np.arange(self.grad_acc * self.rows_per_step,
                                        dtype=np.int64)

    def skip_steps(self, n_steps: int) -> None:
        """Advance the cursor past ``n_steps`` global batches (resume)."""
        total = n_steps * self.grad_acc * self.rows_per_step
        wraps, self._cursor = divmod(self._cursor + total, len(self.samples))
        self._epoch += wraps

    def seek_steps(self, n_steps: int) -> None:
        """Put the cursor at the start of global batch ``n_steps``, from
        wherever it is."""
        self._cursor = 0
        self._epoch = 0
        self.skip_steps(n_steps)

    def state_meta(self, step: int) -> dict:
        """The position after ``step`` global batches and the geometry it
        was computed from, for a checkpoint's metadata."""
        return {
            "consumed_steps": int(step),
            "consumed_rows": int(step) * self.grad_acc * self.rows_per_step,
            "grad_acc": self.grad_acc,
            "rows_per_step": self.rows_per_step,
            "seq_length": self.seq_length,
            "num_samples": len(self.samples),
        }

    def verify_resume(self, saved: Optional[dict], step: int) -> None:
        """Hold a checkpoint's saved position against what
        ``skip_steps(step)`` gives under this config, and raise on any
        difference: a changed micro-batch size, grad-accum, seq_length or
        corpus size would resume on other tokens than the saving run's. A
        checkpoint without the record (``saved`` None) passes."""
        if not saved:
            return
        cur = self.state_meta(step)
        bad = {k: (saved[k], cur[k])
               for k in sorted(set(saved) & set(cur)) if saved[k] != cur[k]}
        if bad:
            detail = ", ".join(
                f"{k}: saved={s} now={n}" for k, (s, n) in bad.items())
            raise ValueError(
                f"checkpoint data-loader position does not match this "
                f"config ({detail}); the batch geometry changed between "
                f"save and resume — resuming would silently train on "
                f"different data. Restore under the saving run's geometry "
                f"or start a fresh run.")

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        M, R = self.grad_acc, self.rows_per_step
        n = len(self.samples)
        abs_idx = (self._cursor + self._batch_offsets) % n
        wraps, self._cursor = divmod(self._cursor + M * R, n)
        self._epoch += wraps
        rows = self.samples[abs_idx]
        shape = (M, R, self.seq_length)
        return {"input_ids": np.ascontiguousarray(rows[:, :-1]).reshape(shape),
                "target_ids": np.ascontiguousarray(rows[:, 1:]).reshape(shape)}
