"""End-to-end LM training example: train a small model for a few hundred
steps with the full production loop: data pipeline with prefetch and a
resumable cursor, AdamW, hierarchical sparse embedding-gradient
accumulation (the paper's technique as a first-class feature), async
checkpointing, straggler monitoring.

Run::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen2_0_5b --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 4 --device cpu

The architecture is reduced to smoke-test size (``configs.reduced``);
:func:`train` takes any ``ModelConfig``, the published widths included.

For an untied table (``--hier-embed-grad``, the default) the table's dense
gradient, which the embedding gather's backward writes with the
``scatter_add`` kernel, is taken apart into ``(token, row)`` pairs: each
position contributes its token's row of that gradient (as the reference's
demonstration path does, so a token seen n times adds its summed row n
times; ROADMAP C25), they go through the ``HierRowAccum`` cascade, and the
flushed rows get a lazy AdamW update while the dense update sees a zero
table gradient.

The checkpoint's cursor is the count of batches consumed, and
``resume=True`` (``--resume``) starts from the newest checkpoint in
``ckpt_dir`` at that batch.  (The reference saves ``stream.cursor()``,
which the prefetch thread has already advanced past the batches in its
queue, so a restart from it would skip them; ROADMAP C26.)
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import d4m
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.tokens import Prefetcher, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import straggler
from repro_torch.sparse import hier_grad as HG
from repro_torch.sparse import row_accum as RA


def train(
    cfg: ModelConfig,
    steps: int = 200,
    batch: int = 8,
    seq: int = 64,
    hier_embed_grad: bool = True,
    ckpt_every: int = 100,
    ckpt_dir: Optional[str] = None,
    device=None,
    resume: bool = False,
) -> dict:
    """The training loop at ``cfg``'s widths, on ``device`` (``cuda``
    unless given); with ``resume``, from the newest checkpoint in
    ``ckpt_dir`` (if any) on to ``steps``.  Returns the losses, step
    times, final params and optimizer state, the last checkpoint's cursor
    and, on the sparse embedding path, the last step's tokens, dense table
    gradient and flushed accumulator."""
    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_lm_ckpt")
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    opt = adamw.init(params)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start = 0
    if resume and mgr.latest_step() is not None:
        saved, extra = mgr.restore({"params": params, "opt": opt})
        params, opt = (TF.tree_map(lambda a: torch.from_numpy(a).to(dev), saved[k]) for k in ("params", "opt"))
        start = extra["cursor"]
    stream = TokenStream(cfg.vocab, batch, seq, seed=1, start_step=start)
    pf = Prefetcher(stream, device=dev)
    mon = straggler.StragglerMonitor(1)
    tokens_per_micro = batch * seq
    # capacity-plan the embedding-grad cascade through the unified D4M
    # config: the streaming sessions' telescoping rule, so the
    # accumulator's memory is reported before allocation
    grad_plan_cfg = d4m.StreamConfig(
        cuts=(2 * tokens_per_micro, 8 * tokens_per_micro),
        top_capacity=min(cfg.vocab_padded, 1 << 16),
        batch_size=tokens_per_micro,
    )
    print("embedding-grad id cascade:")
    print(grad_plan_cfg.plan().describe())
    hg_cfg = HG.HierGradConfig(cuts=grad_plan_cfg.resolved_cuts(), top_capacity=grad_plan_cfg.top_capacity)
    sparse_embed = hier_embed_grad and not cfg.tied_embeddings
    grad_fn = ST.value_and_grad(cfg, ep_axis=None)

    def train_step(params, opt, batch, embed_acc):
        """Grads for everything; on the sparse path the table's gradient
        goes into the hierarchical accumulator as (token, row) pairs and
        the dense update sees zeros in its place."""
        loss, _, grads = grad_fn(params, batch["tokens"], batch["labels"], None)
        emb_g = None
        if sparse_embed:
            emb_g = grads["embed"]["table"]
            rows = emb_g[batch["tokens"].reshape(-1)]  # rows of the (already computed) dense grad
            embed_acc = HG.accumulate_microbatch(
                embed_acc, batch["tokens"], rows.reshape(batch["tokens"].shape + (-1,)), hg_cfg
            )
            grads["embed"]["table"] = torch.zeros_like(emb_g)
        params, opt, metrics = adamw.update(grads, opt, params, opt_cfg)
        return params, opt, loss, metrics, embed_acc, emb_g

    def flush_embed(params, opt, embed_acc):
        flushed = RA.hier_flush(embed_acc)
        HG.sparse_adamw_row_update(  # in place on the table and its moments
            flushed, params["embed"]["table"], opt["m"]["embed"]["table"], opt["v"]["embed"]["table"],
            opt["step"], opt_cfg,
        )
        return flushed

    embed_acc = HG.init_accumulator(hg_cfg, tokens_per_micro, cfg.d_model, device=dev)
    losses, step_ms, cursor, last = [], [], None, None
    try:
        for step in range(start, steps):
            b = next(pf)
            with straggler.StepTimer() as st:
                params, opt, loss, metrics, embed_acc, emb_g = train_step(params, opt, b, embed_acc)
                if sparse_embed:
                    flushed = flush_embed(params, opt, embed_acc)
                    last = {"tokens": b["tokens"], "emb_g": emb_g, "flushed": flushed}
                    embed_acc = RA.hier_reset(embed_acc)
                if dev.type == "cuda":
                    torch.cuda.synchronize()  # the step's time, not its enqueue
            mon.observe_step({0: st.last_ms})
            losses.append(float(loss))
            step_ms.append(st.last_ms)
            if (step + 1) % 50 == 0:
                print(
                    f"step {step+1}: loss {np.mean(losses[-50:]):.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                    f"{st.last_ms:.0f} ms"
                )
            if (step + 1) % ckpt_every == 0:
                cursor = step + 1
                mgr.save_async(step + 1, {"params": params, "opt": opt}, extra={"cursor": cursor})
        mgr.wait()
    finally:
        pf.close()
    first, last_mean = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"loss {first:.3f} -> {last_mean:.3f} ({'OK: decreased' if last_mean < first else 'WARN'})")
    return {"losses": losses, "step_ms": step_ms, "params": params, "opt": opt, "cursor": cursor, "last": last}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--hier-embed-grad", action="store_true", default=True)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None, help="default: repro_lm_ckpt in the temp directory")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--resume", action="store_true", help="start from the newest checkpoint in --ckpt-dir")
    args = ap.parse_args(argv)
    return train(
        reduced(get_config(args.arch)), steps=args.steps, batch=args.batch, seq=args.seq,
        hier_embed_grad=args.hier_embed_grad, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        device=args.device, resume=args.resume,
    )


if __name__ == "__main__":
    main()
