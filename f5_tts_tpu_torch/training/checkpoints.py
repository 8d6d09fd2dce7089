"""Training checkpoints in safetensors files (the port of the JAX package's
`training/checkpoints.py`, without orbax, which is a JAX library).

A trainer writes, per saved step, the weights in the published MLX naming
(loadable by the reference and by either package), the EMA weights beside
them, and a `.trainstate.safetensors` file with the optimizer state and the
step: a tree of tensors and numbers flattened to path keys such as
"['opt_state']['mu']['proj_out.weight']". Restoring needs a template of the
same structure (a freshly initialized state), so a renamed or missing leaf
fails loudly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from f5_tts_tpu_torch.utils.safetensors import load_file, save_file

ORBAX_UNSUPPORTED = (
    "use_orbax: orbax is a JAX library; the port keeps the full train state in "
    ".trainstate.safetensors files (ROADMAP.md queue 1, item 8: orbax checkpoints)"
)


def _flat_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat_with_paths(v, f"{prefix}['{k}']")]
    return [(prefix, tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree_safetensors(path: str | Path, tree) -> None:
    """Write a tree of dicts of tensors and numbers, path-keyed."""
    save_file({k: _to_numpy(v) for k, v in _flat_with_paths(tree)}, Path(path))


def load_tree_safetensors(path: str | Path, template):
    """Load a tree saved by `save_tree_safetensors` into `template`'s
    structure: tensors take the template leaf's shape, dtype and device,
    numbers its Python type. A leaf the file lacks raises KeyError."""
    flat = load_file(Path(path))

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}['{k}']") for k, v in t.items()}
        if prefix not in flat:
            raise KeyError(f"train-state file {path} has no leaf {prefix}; the optimizer "
                           "configuration changed since it was written")
        arr = flat[prefix]
        if isinstance(t, torch.Tensor):
            if arr.size != t.numel():
                raise ValueError(f"{prefix} has {arr.size} elements in {path}, expected {t.numel()}")
            return torch.from_numpy(np.ascontiguousarray(arr)).reshape(t.shape).to(t.device, t.dtype)
        return type(t)(arr.reshape(()).item())

    return build(template, "")


def latest_checkpoint_step(results_dir: str | Path, prefix: str) -> int | None:
    """The newest step with a weights file `<prefix><step>.safetensors` in
    `results_dir` (the resume point of checkpoint="latest")."""
    steps = []
    for p in Path(results_dir).glob(f"{prefix}*.safetensors"):
        stem = p.name.split(".")[0]  # strip .ema / .trainstate
        try:
            steps.append(int(stem.removeprefix(prefix)))
        except ValueError:
            continue
    return max(steps) if steps else None


def save_train_state(state, ts_path: str | Path) -> None:
    """The optimizer state and step of a `TrainState` beside the weights."""
    save_tree_safetensors(ts_path, {"opt_state": state.opt_state, "step": state.step})


def restore_train_state_file(state, ts_path: str | Path, note: str) -> None:
    """Fill opt_state and step of `state` (in place) from a .trainstate
    file, or warn loudly that the resume is weights-only."""
    ts_path = Path(ts_path)
    if ts_path.exists():
        restored = load_tree_safetensors(ts_path, {"opt_state": state.opt_state, "step": state.step})
        state.opt_state = restored["opt_state"]
        state.step = restored["step"]
    else:
        print(
            f"WARNING: no train-state file next to the step weights ({ts_path.name}); resuming "
            f"WEIGHTS-ONLY — optimizer moments and the LR schedule restart from zero ({note})"
        )
