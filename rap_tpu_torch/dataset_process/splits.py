"""Train/val split generation for processed datasets.
(A copy of rap_tpu/dataset_process/splits.py: the port imports nothing of
rap_tpu.)

Parity with the reference's dataset_process/utils/split_utils.py: sequences
kept together (all samples of one sequence land in the same split) vs fully
random splits; both split files are written so the runtime dataset's
bidirectional fallback always finds one (data_split/{train,val}[_random].txt).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _sequence_of(sample_name: str) -> str:
    """Sequence key = first path component (samples are '<seq>/<sample>')."""
    return sample_name.split("/")[0]


def make_splits(
    sample_names: list[str],
    val_fraction: float = 0.1,
    rng: np.random.Generator | None = None,
    keep_sequences_together: bool = True,
    loop_closure_sequences: set[str] | None = None,
    guarantee_loop_closure: bool = False,
    val_sequences: list[str] | None = None,
) -> tuple[list[str], list[str]]:
    """Returns (train, val) sample-name lists.

    Sequence-mode extras (ref split_utils.py:33-175): ``val_sequences`` pins
    named sequences to val (overrides the ratio); ``guarantee_loop_closure``
    forces at least one sequence from ``loop_closure_sequences`` into train —
    SLAM-style relocalization training needs a loop-closing sequence on the
    train side or the model never sees revisit geometry.
    """
    rng = rng or np.random.default_rng(0)
    if keep_sequences_together:
        seqs = sorted({_sequence_of(n) for n in sample_names})
        if val_sequences is not None:
            known = set(seqs)
            val_seqs = {s for s in val_sequences if s in known}
        else:
            order = rng.permutation(len(seqs))
            n_val = (
                max(1, int(round(len(seqs) * val_fraction)))
                if len(seqs) > 1 else 0
            )
            val_seqs = {seqs[i] for i in order[:n_val]}
            if guarantee_loop_closure and loop_closure_sequences:
                lc = set(loop_closure_sequences) & set(seqs)
                if lc and lc <= val_seqs:
                    # move the largest loop-closure sequence back to train
                    # and swap in the largest non-loop val candidate
                    counts = {
                        s: sum(_sequence_of(n) == s for n in sample_names)
                        for s in seqs
                    }
                    keep = max(lc, key=lambda s: counts[s])
                    val_seqs.discard(keep)
                    non_lc = [s for s in seqs if s not in lc and s not in val_seqs]
                    if non_lc:
                        val_seqs.add(max(non_lc, key=lambda s: counts[s]))
        train = [n for n in sample_names if _sequence_of(n) not in val_seqs]
        val = [n for n in sample_names if _sequence_of(n) in val_seqs]
    else:
        order = rng.permutation(len(sample_names))
        n_val = max(1, int(round(len(sample_names) * val_fraction)))
        val_idx = set(order[:n_val].tolist())
        train = [n for i, n in enumerate(sample_names) if i not in val_idx]
        val = [n for i, n in enumerate(sample_names) if i in val_idx]
    return train, val


def write_split_files(
    root: str | Path,
    train: list[str],
    val: list[str],
    random_split: bool = False,
) -> None:
    """Write data_split/{train,val}[_random].txt under the dataset root."""
    d = Path(root) / "data_split"
    d.mkdir(parents=True, exist_ok=True)
    suffix = "_random" if random_split else ""
    (d / f"train{suffix}.txt").write_text("\n".join(train) + ("\n" if train else ""))
    (d / f"val{suffix}.txt").write_text("\n".join(val) + ("\n" if val else ""))


def write_num_points_files(
    root: str | Path,
    split_name: str,
    num_points: list[int],
) -> None:
    """num_points/<split>.txt aligned with the split file's sample order
    (consumed by the batch planner)."""
    d = Path(root) / "num_points"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{split_name}.txt").write_text(
        "\n".join(str(int(n)) for n in num_points) + ("\n" if num_points else "")
    )
