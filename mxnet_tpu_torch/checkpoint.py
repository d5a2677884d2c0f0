"""Training checkpoints: asynchronous, atomic and resume-exact.

Counterpart of mxnet_tpu/checkpoint.py (`TrainCheckpoint`,
`install_preemption_handler`). The reference writes through orbax; this
port writes its own layout, so its checkpoints are not orbax
checkpoints (parameter files still cross both ways, serialization.py):

  <directory>/<step>/state.npz    the state, in the serialization format
  <directory>/<step>/cursor.json  the data cursor, when one was given

A step is written under `<step>.tmp` and renamed once its files are
flushed to disk, so `latest_step()` never sees half a checkpoint, and
the oldest steps past `max_to_keep` are deleted after each rename.

The state is the reference's `_state_of` in the port's terms: every
parameter of the net (trainable or not: BatchNorm's running statistics
are parameters), the optimizer states with their float32 masters, the
step count, the base seed of the per-step dropout generators (so the
resumed steps draw the same masks and fused-attention seed words), and
the loss-scale state with a has-scale flag (a checkpoint without loss
scaling restored into a dynamic step keeps its initial 2^16), and under
`compression="2bit"` each dp shard's error-feedback residuals. A mesh
step's parameter blocks held on other devices are pulled into the net's
tensors before a save (`sync_params`) and pushed back out after a
restore.

`save()` copies every tensor to host memory (pinned, from a card) and
waits for the copies before it returns, so the next step may overwrite
the buffers in place; one background thread then writes the files.
`last_save` holds the blocking seconds, the bytes and, once the write is
durable, the seconds until then.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import time

import torch

from .base import MXNetError
from .serialization import load_tensor_dict, save_ndarray_dict

__all__ = ["TrainCheckpoint", "install_preemption_handler"]

_STATE = "state.npz"
_CURSOR = "cursor.json"
_TMP = ".tmp"


def _named_params(train_step):
    """name -> torch parameter of the whole net, and the trainable ones'
    names in the step's order."""
    named = dict(train_step.net.named_parameters())
    name_of = {id(p): n for n, p in named.items()}
    return named, [name_of[id(p)] for p in train_step._params]


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainCheckpoint:
    """Checkpoint manager for a `parallel.TrainStep`.

    Usage:
        ckpt = TrainCheckpoint(directory, max_to_keep=3)
        ckpt.save(step, train_step, data_cursor={"epoch": e, "batch": i})
        ...
        cursor = ckpt.restore(train_step)   # the latest step
    """

    def __init__(self, directory, max_to_keep=3, async_save=True):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        for name in os.listdir(self._dir):
            if name.endswith(_TMP):   # a write an earlier process lost
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = []
        self._saving = False
        self._preempt_pending = None
        self.last_save = {}

    # -- the state ---------------------------------------------------------
    @staticmethod
    def _state_of(train_step):
        train_step.sync_params()
        named, trainable = _named_params(train_step)
        state = {f"param/{n}": p.detach() for n, p in named.items()}
        for n, states in zip(trainable, train_step._states):
            for j, s in enumerate(states):
                state[f"opt/{n}/{j}"] = s
        state["t"] = torch.tensor(train_step._t, dtype=torch.int64)
        state["seed"] = torch.tensor(train_step._seed, dtype=torch.int64)
        state["has_seed"] = torch.tensor(True)
        scale = train_step._scale_state
        state["has_scale"] = torch.tensor(scale is not None)
        if scale is not None:
            state["scale"], state["scale_good"] = scale
        for n, r in zip(trainable, train_step._residuals):
            state[f"resid/{n}"] = r
        return state

    @staticmethod
    def _snapshot(state):
        """Host copies of every tensor, finished before this returns."""
        out, on_card = {}, False
        for k, v in state.items():
            if v.device.type == "cpu":
                out[k] = v.detach().clone()
            else:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                out[k] = buf
                on_card = True
        if on_card:
            torch.cuda.synchronize()
        return out

    # -- save ----------------------------------------------------------------
    def save(self, step, train_step, data_cursor=None, wait=False):
        """Save the whole training state at `step`: the host snapshot
        blocks, the write runs on the background thread (unless wait, or
        async_save=False). data_cursor is any small JSON value."""
        self._raise_failed()
        step = int(step)
        self._saving = True
        try:
            t0 = time.perf_counter()
            snap = self._snapshot(self._state_of(train_step))
            blocking = time.perf_counter() - t0
            nbytes = sum(v.numel() * v.element_size() for v in snap.values())
            self.last_save = {"step": step, "blocking_s": blocking,
                              "bytes": nbytes}
            cursor = None if data_cursor is None else json.dumps(data_cursor)
            self._pending.append(self._writer.submit(
                self._write, step, snap, cursor, t0, self.last_save))
            if wait or not self._async:
                self.wait_until_finished()
        finally:
            self._saving = False
        # a preemption signal that landed during the save deferred itself
        pending, self._preempt_pending = self._preempt_pending, None
        if pending is not None:
            pending()

    def _write(self, step, snap, cursor, t0, record):
        final = os.path.join(self._dir, str(step))
        tmp = final + _TMP
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE), "wb") as f:
            save_ndarray_dict(f, snap)
            f.flush()
            os.fsync(f.fileno())
        if cursor is not None:
            with open(os.path.join(tmp, _CURSOR), "w") as f:
                f.write(cursor)
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self._dir)
        record["durable_s"] = time.perf_counter() - t0
        if self._max_to_keep:
            for old in self.all_steps()[:-self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)

    @property
    def save_in_progress(self):
        """True while a save() call is on the stack (the preemption
        handler defers to it)."""
        return self._saving

    def _raise_failed(self):
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()   # re-raises a failed write

    def wait_until_finished(self):
        """Block until every pending save is durable (call before the
        process exits); re-raises a failed write."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    # -- restore -------------------------------------------------------------
    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def restore(self, train_step, step=None):
        """Restore into the step's tensors (in place, on their devices):
        every parameter of the net, the optimizer states, the step count,
        the dropout seed and the loss-scale state. Returns the stored
        data cursor, or None."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise MXNetError(f"no checkpoint found under {self._dir}")
        path = os.path.join(self._dir, str(int(step)))
        if not os.path.isdir(path):
            raise MXNetError(f"no checkpoint for step {step} under "
                             f"{self._dir} (have {self.all_steps()})")
        state = load_tensor_dict(os.path.join(path, _STATE))
        named, trainable = _named_params(train_step)
        want = {f"param/{n}" for n in named} | {
            f"opt/{n}/{j}" for n, states in zip(trainable,
                                                train_step._states)
            for j in range(len(states))} | {
            f"resid/{n}" for n, _ in zip(trainable, train_step._residuals)}
        have = {k for k in state
                if k.startswith(("param/", "opt/", "resid/"))}
        if want != have:
            raise MXNetError(
                f"checkpoint {path} does not match the step: missing "
                f"{sorted(want - have)[:8]}, unexpected "
                f"{sorted(have - want)[:8]}")
        with torch.no_grad():
            for n, p in named.items():
                self._copy(p, state[f"param/{n}"], n)
            for n, states in zip(trainable, train_step._states):
                for j, s in enumerate(states):
                    self._copy(s, state[f"opt/{n}/{j}"], f"{n} state {j}")
            for n, r in zip(trainable, train_step._residuals):
                self._copy(r, state[f"resid/{n}"], f"{n} residual")
        train_step._after_restore()
        t = int(state["t"])
        train_step._t = t
        train_step.optimizer.num_update = t
        if bool(state["has_seed"]):
            train_step._seed = int(state["seed"])
        if train_step._scale_state is not None and bool(state["has_scale"]):
            dev = train_step._scale_state[0].device
            train_step._scale_state = (
                state["scale"].to(dev, torch.float32),
                state["scale_good"].to(dev, torch.int32))
        cursor = os.path.join(path, _CURSOR)
        if not os.path.exists(cursor):
            return None
        with open(cursor) as f:
            return json.load(f)

    @staticmethod
    def _copy(dst, src, name):
        if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
            raise MXNetError(f"checkpoint {name}: {tuple(src.shape)} "
                             f"{src.dtype}, the step has "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)

    def close(self):
        self.wait_until_finished()
        self._writer.shutdown(wait=True)


def install_preemption_handler(ckpt, train_step, get_step, get_cursor=None,
                               signals=None):
    """On SIGTERM (a preemption notice), save the whole training state and
    the data cursor synchronously, then re-raise the signal with the
    previous handler so the process exits. A signal that lands inside a
    step saves once the step has returned, so the checkpoint is at a
    step boundary. Returns a remover.

    Usage:
        remove = install_preemption_handler(
            ckpt, step, get_step=lambda: step.step_count,
            get_cursor=lambda: {"epoch": epoch, "batch": i})
    """
    import signal as _signal

    signals = signals or [_signal.SIGTERM]
    previous = {}

    def finish(signum):
        prev = previous.get(signum)
        _signal.signal(signum, prev if prev is not None else _signal.SIG_DFL)
        _signal.raise_signal(signum)

    def save_then_finish(signum, completed=True):
        # a step that raised may have updated only some tensors: the
        # last complete checkpoint stands
        if completed:
            ckpt.save(int(get_step()), train_step,
                      data_cursor=get_cursor() if get_cursor else None,
                      wait=True)
        finish(signum)

    def handler(signum, frame):
        # a signal that lands inside ckpt.save must not re-enter it: the
        # interrupted save finishes when this returns, then runs this
        if ckpt.save_in_progress:
            def deferred():
                try:
                    ckpt.wait_until_finished()
                except Exception:
                    pass
                finish(signum)
            ckpt._preempt_pending = deferred
            return
        # nor may it snapshot a step half updated in place: the save
        # waits for the step's end
        train_step.defer_to_step_end(
            lambda completed: save_then_finish(signum, completed))

    for s in signals:
        previous[s] = _signal.signal(s, handler)

    def remove():
        for s, prev in previous.items():
            _signal.signal(s, prev if prev is not None else _signal.SIG_DFL)

    return remove
