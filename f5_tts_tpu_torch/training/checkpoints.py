"""Training checkpoints (the port of the JAX package's
`training/checkpoints.py`).

A trainer writes, per saved step, the weights in the published MLX naming
(loadable by the reference and by either package) and the EMA weights
beside them. The rest of the train state goes either into a
`.trainstate.safetensors` file with the optimizer state and the step (a
tree of tensors and numbers flattened to path keys such as
"['opt_state']['mu']['proj_out.weight']"; restoring needs a template of
the same structure, so a renamed or missing leaf fails loudly), or, with
`use_orbax=True`, into a `TrainCheckpointManager`: the counterpart of the
JAX package's orbax manager over `torch.distributed.checkpoint`. It keeps
the whole state (parameters, AdamW moments, EMA, update count, step)
sharded as the grid holds it, each piece written once by the slot that owns
it, asynchronously, with retention (`max_to_keep`) and the committed steps
(`latest_step`, `all_steps`) as the crash-resume points. Its format is the
port's own (a torch.distributed.checkpoint directory a step, keys
"<params|mu|nu|ema>/<global data row>.<model column>/<name>", and a
layout.json with the grid's shape across the processes, "seq" included,
its "data" the global data axis, and the specs; the seq slots hold copies
of seq index 0's pieces and write nothing). With several processes each
writes only the pieces of its own global rows, so under FSDP no two
processes write one key; a replicated tensor is written by global row 0
alone. A restore reassembles the full tensors over the global rows and cuts
them for the target's layout, so a state saved over one grid, or by several
processes, resumes over another, in one process or several, or unsharded.
"""

from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from f5_tts_tpu_torch.parallel import distributed as D
from f5_tts_tpu_torch.parallel.mesh import ShardedTrainState, assemble, owns, piece
from f5_tts_tpu_torch.utils.safetensors import load_file, save_file


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


def latest_checkpoint_step(results_dir: str | Path, prefix: str, ckpt_mgr=None) -> int | None:
    """The newest resumable step (checkpoint="latest"). With a checkpoint
    manager its committed steps win: a newer weights file can exist when a
    crash came between the weights' write and the manager's asynchronous
    commit, and resuming from it would lose the optimizer state. Else the
    newest step with a weights file `<prefix><step>.safetensors` in
    `results_dir`."""
    if ckpt_mgr is not None:
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            return int(latest)
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


# ------------------------------------------------- the sharded, asynchronous manager

LAYOUT = "layout.json"
KINDS = ("params", "mu", "nu", "ema")


def _per_slot(state) -> tuple[list, dict, dict, dict]:
    """(this process's slots as (global data row, model column, seq index),
    the specs, the grid's shape across the processes, {kind: one dict a slot
    or None}) of a sharded or an unsharded state."""
    if isinstance(state, ShardedTrainState):
        coords = [(state.global_row(r), j, q) for r, q, j, _ in state.slots]
        tensors = {"params": state.params, "mu": state.opt_state["mu"], "nu": state.opt_state["nu"],
                   "ema": state.ema}
        return coords, state.specs, state.global_shape, tensors
    params = dict(state.model.named_parameters())
    tensors = {"params": [params], "mu": [state.opt_state["mu"]], "nu": [state.opt_state["nu"]],
               "ema": None if state.ema is None else [state.ema]}
    return [(0, 0, 0)], {n: (None,) * p.ndim for n, p in params.items()}, {"data": 1, "model": 1}, tensors


def owned_pieces(state) -> dict[str, torch.Tensor]:
    """The pieces that this process writes of a sharded or an unsharded
    state, by key "<kind>/<global data row>.<model column>/<name>": each
    piece that one of its slots owns (`owns` by the global row)."""
    coords, specs, _, tensors = _per_slot(state)
    out = {}
    for s, (r, j, q) in enumerate(coords):
        for name, spec in specs.items():
            if owns(spec, r, j, q):
                for kind, slots in tensors.items():
                    if slots is not None:
                        out[f"{kind}/{r}.{j}/{name}"] = slots[s][name]
    return out


class TrainCheckpointManager:
    """The whole train state, sharded, through torch.distributed.checkpoint:
    a directory a step under `directory`, written asynchronously (the state
    is copied to host memory before `save` returns, then written by a
    thread), at most `max_to_keep` committed steps kept. One save is in
    flight at a time; `wait` and `close` block until it is committed.
    Works in one process without a process group, and across the processes
    of one (each piece written once, by the process whose global row owns
    it). Across processes every one constructs it (a collective), and it
    saves and loads over a gloo group of its own: the write thread's
    collectives then never interleave with the training step's, nor with
    the gathers of FSDP across processes."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3, async_save: bool = True):
        import torch.distributed as dist

        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._pending = None
        self._group = dist.new_group(backend="gloo") if D.process_count() > 1 else None

    def _dist(self) -> dict:
        return {"no_dist": self._group is None, "process_group": self._group}

    def save(self, step: int, state) -> None:
        """Stage the state on the host and start writing it (asynchronous
        unless async_save=False)."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        self.wait()
        _, specs, shape, tensors = _per_slot(state)
        flat = {key: t.detach().to("cpu", copy=True) for key, t in owned_pieces(state).items()}
        count = state.opt_state["count"]
        flat["count"], flat["step"] = int(count), int(state.step)
        path = self.directory / str(step)
        if D.process_index() == 0:
            shutil.rmtree(path, ignore_errors=True)
            path.mkdir(parents=True)
            layout = {"shape": shape, "specs": {n: list(sp) for n, sp in specs.items()},
                      "ema": tensors["ema"] is not None}
            (path / LAYOUT).write_text(json.dumps(layout))
        if D.process_count() > 1:
            dist.barrier()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            if self.async_save:
                self._pending = dcp.async_save(flat, checkpoint_id=path, **self._dist())
            else:
                dcp.save(flat, checkpoint_id=path, **self._dist())
                self._prune()

    def _layout(self, step: int) -> dict:
        return json.loads((self.directory / str(step) / LAYOUT).read_text())

    def has_ema(self, step: int) -> bool:
        return self._layout(step)["ema"]

    def restore(self, step: int, state, ema: bool = True):
        """Fill `state` (sharded or not, over any grid) in place from the
        step and return it. Raises KeyError when the names differ, and
        ValueError when one side has an EMA and the other not (unless
        ema=False: then the EMA is neither read nor written)."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import TensorStorageMetadata

        self.wait()
        path = self.directory / str(step)
        layout = self._layout(step)
        coords, specs, shape, tensors = _per_slot(state)
        if sorted(layout["specs"]) != sorted(specs):
            missing = sorted(set(specs) ^ set(layout["specs"]))
            raise KeyError(f"checkpoint step {step} in {self.directory} does not hold the state's tensors: {missing[:5]}")
        if ema and layout["ema"] != (tensors["ema"] is not None):
            raise ValueError(f"checkpoint step {step} {'has' if layout['ema'] else 'has no'} EMA; the state "
                             f"{'has none' if tensors['ema'] is None else 'has one'}")
        metadata = dcp.FileSystemReader(path).read_metadata()
        flat = {k: torch.empty(m.size, dtype=m.properties.dtype) if isinstance(m, TensorStorageMetadata) else 0
                for k, m in metadata.state_dict_metadata.items()}
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            dcp.load(flat, checkpoint_id=path, **self._dist())
        kinds = [k for k in KINDS if tensors[k] is not None and (k != "ema" or ema)]
        with torch.no_grad():
            for name, saved_spec in layout["specs"].items():
                saved_spec = tuple(saved_spec)
                for kind in kinds:
                    pieces = {(r, j): flat[f"{kind}/{r}.{j}/{name}"] for r in range(layout["shape"]["data"])
                              for j in range(layout["shape"]["model"]) if owns(saved_spec, r, j)}
                    full = assemble(pieces, saved_spec, layout["shape"], "cpu")
                    for s, (r, j, _) in enumerate(coords):
                        target = tensors[kind][s][name]
                        target.copy_(piece(full, specs[name], r, j, shape))
        state.opt_state["count"] = int(flat["count"])
        state.step = int(flat["step"])
        return state

    def all_steps(self) -> list[int]:
        """The committed steps (their metadata written), oldest first."""
        steps = [int(p.name) for p in self.directory.iterdir()
                 if p.name.isdigit() and (p / ".metadata").exists()]
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        if D.process_index() == 0:
            for step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(step), ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is committed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
            self._prune()

    def close(self) -> None:
        self.wait()


def restore_orbax_adapting_ema(ckpt_mgr: TrainCheckpointManager, step: int, state):
    """Restore the whole state, adapting a changed ema_decay setting: a
    checkpoint without EMA starts the EMA from the restored parameters, and
    one with an EMA the state does not track drops it (each with a
    warning)."""
    wanted = state.ema is not None
    if ckpt_mgr.has_ema(step) == wanted:
        return ckpt_mgr.restore(step, state)
    ckpt_mgr.restore(step, state, ema=False)
    if wanted:
        print("warning: checkpoint has no EMA; re-initializing EMA from params")
        _, _, _, tensors = _per_slot(state)
        with torch.no_grad():
            for ema, params in zip(tensors["ema"], tensors["params"]):
                for name, t in ema.items():
                    t.copy_(params[name])
    else:
        print("warning: checkpoint has EMA but ema_decay is None; dropping it")
    return state


def resume(trainer, checkpoint: int | str | None, prefix: str) -> int:
    """A trainer's resume, shared by both trainers: "latest" resolves by
    `latest_checkpoint_step`; a step the checkpoint manager committed
    restores the whole state from it, any other loads the step's files
    (`trainer.load_checkpoint`). Returns the step to start from."""
    mgr = trainer.ckpt_mgr
    if checkpoint == "latest":
        checkpoint = latest_checkpoint_step(trainer.results_dir, prefix, mgr)
        if checkpoint is None:
            print("No checkpoint found; starting fresh")
    if checkpoint is None:
        return 0
    if mgr is not None and checkpoint in mgr.all_steps():
        trainer.state = restore_orbax_adapting_ema(mgr, checkpoint, trainer.state)
    else:
        if mgr is not None:
            print(f"warning: step {checkpoint} is not in the checkpoint manager; resuming from the safetensors "
                  "files (the whole train state when a .trainstate file exists, else weights-only)")
        trainer.load_checkpoint(checkpoint)
    print(f"Starting training at step {checkpoint}")
    return checkpoint
