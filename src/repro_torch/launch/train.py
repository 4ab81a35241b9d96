"""The training entry point: the loss, the train step and the
fault-tolerant loop — the port of `repro/launch/train.py`.

Usage (runs on the card unless `--device cpu`):
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 200 --batch 8 --seq 256 --reduced --device cpu

The step computes the loss through `Model.train_outputs` (every causal
attention layer runs `flash_prefill` forward and `flash_prefill_bwd`
backward on the card; an MLA layer their latent routes), with the MTP
head's loss where the model has one (deepseek-v3), takes the gradients
with `torch.autograd.grad` over the parameter leaves, and applies the
learning-rate schedule and `adamw.update`, which writes the parameters and
moments in place.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.core import baselines
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, schedule
from repro_torch.runtime import fault
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor       # int32 scalar


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE. logits [B,T,V] f32, targets [B,T] int."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def chunked_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor, chunk: int = 512
                          ) -> torch.Tensor:
    """CE without making [B,T,V]: each [B,c,d] slice of the sequence goes
    through the head in f32 inside the loop; the pad rows of the last
    chunk are masked."""
    b, t, d = h.shape
    pad = (-t) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    headf = head.float()
    live = (torch.arange(t + pad, device=h.device) < t).float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, t + pad, chunk):
        logits = h[:, c0:c0 + chunk].float() @ headf          # [B,c,V]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets[:, c0:c0 + chunk, None].long())[..., 0]
        tot = tot + torch.sum((lse - gold) * live[None, c0:c0 + chunk])
    return tot / (b * t)


def make_loss_fn(model: Model, mtp_weight: float = 0.3,
                 loss_chunk: int = 0):
    """(params, batch) → (loss, metrics): next-token CE plus the aux loss;
    metrics "loss" (the CE) and "aux". Where the model's outputs hold
    "mtp_logits" (its MTP head), `mtp_weight` times their CE against the
    token two ahead joins the loss, as metric "mtp_loss". With
    `loss_chunk` the head is projected chunk by chunk from `train_hidden`
    and, as in the reference, no MTP loss is taken."""
    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=model.device)
        if loss_chunk:
            h, aux = model.train_hidden(params, batch)
            ce = chunked_cross_entropy(h[:, :-1], model.head_matrix(params),
                                       tokens[:, 1:], loss_chunk)
            outs = {"aux": aux}
        else:
            outs = model.train_outputs(params, batch)
            ce = cross_entropy(outs["logits"][:, :-1], tokens[:, 1:])
        loss = ce + outs["aux"]
        metrics = {"loss": ce, "aux": outs["aux"]}
        if "mtp_logits" in outs:
            # the head predicts token t + 2 from (h_t, e_{t+1})
            mtp_ce = cross_entropy(outs["mtp_logits"][:, :-1], tokens[:, 2:])
            loss = loss + mtp_weight * mtp_ce
            metrics["mtp_loss"] = mtp_ce
        return loss, metrics
    return loss_fn


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    total_steps: int, peak_lr: float = 3e-4,
                    warmup: int = 100, loss_chunk: int = 0):
    """(state, batch) → (state, metrics): the loss and its gradients over
    every parameter leaf, the warmup-cosine rate at the optimizer's step,
    and one AdamW update (in place). Metrics: loss, aux, lr, grad_norm
    and, for a model with an MTP head, mtp_loss (f32 scalar tensors on the
    model's device)."""
    loss_fn = make_loss_fn(model, loss_chunk=loss_chunk)

    def train_step(state: TrainState, batch):
        # fresh autograd leaves over the parameters' storage, which the
        # update then writes in place
        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        state.params)
        flat = leaves(live)
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        lr = schedule.warmup_cosine(state.opt.step, peak_lr, warmup,
                                    total_steps)
        grad_norm = adamw.global_norm(grads)
        params, opt = adamw.update(grads, state.opt, state.params, opt_cfg,
                                   lr)
        metrics.update(lr=lr, grad_norm=grad_norm)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def init_train_state(model: Model, opt_cfg: adamw.AdamWConfig,
                     seed: int = 0) -> TrainState:
    """Random weights from `seed` (`Model.init`), zero moments, step 0."""
    params = model.init(seed)
    return TrainState(params=params, opt=adamw.init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def frontend_inputs(cfg: ModelConfig, step: int, batch_size: int,
                    seed: int = 0) -> dict:
    """A frontend model's stub embeddings for a step, N(0, 1) from numpy
    seeded by (seed, step): an enc-dec model's `enc_embed` or a frontend
    model's `<frontend>_embed`, [batch_size, frontend_len, d_model] f32
    ({} for a model without a frontend)."""
    if cfg.frontend == "none":
        return {}
    key = ("enc_embed" if cfg.family == "encdec"
           else f"{cfg.frontend}_embed")
    rng = np.random.default_rng(seed * 1_000_003 + step)
    return {key: rng.standard_normal(
        (batch_size, cfg.frontend_len, cfg.d_model)).astype(np.float32)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block's activations in the "
                         "backward")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    prune = baselines.unicaim(heavy=min(448, args.seq), reserve=64,
                              select_k=64)
    model = Model(cfg, prune, device=args.device, remat=args.remat)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                quantized_state=args.quantized_opt)
    state = init_train_state(model, opt_cfg, 0)
    step_fn = make_train_step(model, opt_cfg, args.steps, peak_lr=args.lr)
    src = SyntheticSource(cfg.vocab_size, args.seq)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    def data_iter(step):
        batch = {"tokens": src.batch(step, args.batch),
                 **frontend_inputs(cfg, step, args.batch)}
        return {k: torch.as_tensor(v, device=model.device)
                for k, v in batch.items()}

    def on_metrics(step, m):
        if step % 10 == 0:
            print(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}")

    state, stats = fault.run_training(
        step_fn, state, data_iter, args.steps, ckpt,
        fault.FaultConfig(ckpt_every=args.ckpt_every),
        on_metrics=on_metrics)
    print(f"done: {stats.steps} steps, {stats.restarts} restarts, "
          f"final loss {stats.losses[-1] if stats.losses else float('nan'):.4f}")


if __name__ == "__main__":
    main()
