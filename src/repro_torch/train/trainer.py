"""Training loop substrate: the train step and the host loop, one device.

The counterpart of the JAX package's ``train/trainer.py``.
``make_train_step`` assembles loss -> gradients (autograd over the
parameters, which ``layers.trainable`` makes differentiable for the pass)
-> AdamW into one step ``(params, opt_state, batch) -> (params, opt_state,
metrics)``, the metrics ``loss``, ``lr`` and ``grad_norm`` as 0-d tensors.
As in the reference:

  * with ``accum == 1`` the gradients have the parameters' dtype; with
    ``accum > 1`` the batch's leaves carry a leading ``accum`` dim, the
    gradients are a float32 sum from float32 zeros, and the loss and the
    gradients are divided by ``accum``;
  * the learning rate is the schedule at the state's step BEFORE the
    update (the first step under a warmup runs at lr 0).

The step updates the parameters and the optimizer state in place and
returns them (the reference's jitted step donates both).

``Trainer`` is the host loop: microbatch accumulation, the wall-clock step
watchdog (``slow_steps``), SIGTERM -> checkpoint-and-exit (preemption),
checkpoints every ``checkpoint_every`` steps, and a resume from the stored
step (the data function is deterministic in the step, so a resume replays
the exact batch sequence). It waits for the card once at each step
boundary (``torch.cuda.synchronize``), where the reference blocks on the
loss. Checkpoints hold the reference's trees (``layers.params_to_tree``,
``opt_state_to_tree``), so either package resumes the other's run.

``zero1_spec`` and ``zero1_state_specs`` shard the optimizer state over a
mesh's data axis; they raise until the mesh paths are ported (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch.models.layers import (
    flat_to_tree,
    host_array,
    param_leaves,
    params_from_tree,
    params_to_tree,
    tensor_from_numpy,
    trainable,
    tree_to_flat,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import cosine_with_warmup

__all__ = ["make_train_step", "zero1_state_specs", "Trainer", "TrainerConfig",
           "opt_state_to_tree", "opt_state_from_tree"]


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name} shards the optimizer state over a device mesh's data axis (ZeRO-1); "
        "the mesh paths are ROADMAP A7")


def zero1_spec(spec, shape, n_data: int, data_axes, mesh_shape=None):
    _needs_mesh("zero1_spec")


def zero1_state_specs(param_specs, params, opt_state, n_data: int, data_axes,
                      mesh_shape: dict | None = None):
    _needs_mesh("zero1_state_specs")


def opt_state_to_tree(state, stacked: tuple[str, ...] = ()) -> dict:
    """The optimizer state as the reference's tree of host numpy arrays
    (``init_opt_state``'s structure, stacked segments ``[L, ...]``)."""
    return {"m": flat_to_tree(state["m"], stacked), "v": flat_to_tree(state["v"], stacked),
            "step": host_array(state["step"])}


def opt_state_from_tree(tree, stacked: tuple[str, ...] = (), device=None) -> dict:
    """The reference's optimizer-state tree (numpy arrays or tensors) as the
    port's state on ``device``."""
    def moments(t):
        return {n: ({k: tensor_from_numpy(a, device) for k, a in v.items()}
                    if isinstance(v, dict) else tensor_from_numpy(v, device))
                for n, v in tree_to_flat(t, stacked).items()}

    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": tensor_from_numpy(tree["step"], device).to(torch.int32)}


def _grads(loss_fn, params, batch, leaves):
    with trainable(params):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), grads


def make_train_step(
    loss_fn: Callable,  # loss_fn(params, batch) -> scalar
    opt_cfg: AdamWConfig,
    *,
    accum: int = 1,
    lr_schedule: Callable | None = None,
    donate: bool = True,
):
    """Build a train step: (params, opt_state, batch) -> updated, in place.
    ``donate`` is accepted for the reference's signature; the step always
    reuses its arguments' memory."""
    del donate

    def default_lr(step):
        return torch.tensor(opt_cfg.lr, dtype=torch.float32, device=step.device)

    lr_schedule = lr_schedule or default_lr

    def step(params, opt_state, batch):
        leaves = param_leaves(params)
        if accum == 1:
            loss, grads = _grads(loss_fn, params, batch, leaves)
        else:
            # Microbatch accumulation: batch leaves carry a leading accum dim.
            dev = opt_state["step"].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves.values()]
            for i in range(accum):
                micro = {k: v[i] for k, v in batch.items()}
                lo, g = _grads(loss_fn, params, micro, leaves)
                loss = loss + lo
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / accum
            grads = [g / accum for g in grads]

        lr = lr_schedule(opt_state["step"])
        params, opt_state, metrics = adamw_update(
            params, dict(zip(leaves, grads)), opt_state, opt_cfg, lr
        )
        metrics = dict(metrics, loss=loss, lr=lr)
        return params, opt_state, metrics

    return step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    step_timeout_s: float = 0.0  # >0 enables the straggler watchdog
    lr: float = 3e-4
    warmup: int = 10
    moment_dtype: str = "fp32"
    grad_clip: float = 1.0
    accum: int = 1


class Trainer:
    """Host training loop with fault tolerance, on the parameters' device.

    * SIGTERM triggers checkpoint-and-exit (preemption handling);
    * the data iterator is (re)seeded from the persisted step counter, so a
      restore resumes the exact batch sequence;
    * a per-step watchdog counts steps exceeding ``step_timeout_s`` (the
      straggler hook).
    """

    def __init__(
        self,
        loss_fn,
        params,
        cfg: TrainerConfig,
        data_fn: Callable[[int], dict],  # step -> batch (deterministic)
        checkpointer=None,
    ):
        self.cfg = cfg
        self.opt_cfg = AdamWConfig(
            lr=cfg.lr, moment_dtype=cfg.moment_dtype, grad_clip=cfg.grad_clip
        )
        self.params = params
        self.device = next(iter(params.parameters())).device
        self.opt_state = init_opt_state(params, self.opt_cfg)
        self.data_fn = data_fn
        self.checkpointer = checkpointer
        self.step_fn = make_train_step(
            loss_fn,
            self.opt_cfg,
            accum=cfg.accum,
            lr_schedule=lambda s: cosine_with_warmup(
                s, peak=cfg.lr, warmup=cfg.warmup, total=cfg.total_steps
            ),
        )
        self.history: list[dict] = []
        self.slow_steps = 0
        self._preempted = False

    def _handle_preemption(self, signum, frame):
        del signum, frame
        self._preempted = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state(self) -> dict:
        stacked = self.params.stacked
        return {"params": params_to_tree(self.params),
                "opt_state": opt_state_to_tree(self.opt_state, stacked)}

    def restore(self):
        if self.checkpointer is None:
            return 0
        # To the host first: the live state leaves the card before the
        # restored one arrives (at full width both would not fit).
        state = self.checkpointer.restore_latest(device="cpu")
        if state is None:
            return 0
        stacked = self.params.stacked
        self.params = self.opt_state = None
        self.params = params_from_tree(state["params"], self.device, stacked)
        self.opt_state = opt_state_from_tree(state["opt_state"], stacked, self.device)
        return int(self.opt_state["step"])

    def run(self, install_signal_handlers: bool = True) -> dict:
        start_step = self.restore()
        if install_signal_handlers:
            signal.signal(signal.SIGTERM, self._handle_preemption)
        exit_reason = "completed"
        step = start_step
        for step in range(start_step, self.cfg.total_steps):
            t0 = time.perf_counter()
            batch = self.data_fn(step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            # Step-boundary fence: dt must measure the whole device step.
            self._sync()
            dt = time.perf_counter() - t0
            if self.cfg.step_timeout_s and dt > self.cfg.step_timeout_s:
                self.slow_steps += 1  # straggler hook
            if (step + 1) % self.cfg.log_every == 0 or step == start_step:
                self.history.append(
                    {
                        "step": step + 1,
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "time_s": dt,
                    }
                )
            if self.checkpointer and (step + 1) % self.cfg.checkpoint_every == 0:
                self.checkpointer.save(self._state(), step=step + 1)
            if self._preempted:
                if self.checkpointer:
                    self.checkpointer.save(self._state(), step=step + 1, blocking=True)
                exit_reason = "preempted"
                break
        if self.checkpointer:
            self.checkpointer.wait()
        return {
            "exit": exit_reason,
            "last_step": step + 1,
            "history": self.history,
            "slow_steps": self.slow_steps,
        }
