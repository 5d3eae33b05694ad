"""A float64 witness for zamba2's one-cycle float32 train step, card and CPU.

``chip_smoke.py`` phase 18 holds the gradients of one AdamW step of a
full-width float32 copy of ``zamba2-2.7b`` (one cycle: 6 Mamba2 blocks and
the shared attention block) on the card to the same step on the CPU. At
128 tokens (two of Mamba2's 64-token chunks) the two differed by 1.5e-3 of
max |g|, at 256 tokens by 9.7e-5. A difference between two float32 runs
is either the function's float32 conditioning, which neither run can beat,
or a fault of one of them. This script tells them apart: it takes the
same loss's gradients

- on the card, float32 (the port as it runs there: flash and the rows
  kernel);
- on the CPU, float32 (their plain versions);
- on the CPU in float64, the true gradients up to float64 rounding: the
  model cast to float64, every ``Tensor.float()`` of the model path
  promoted to float64 while it runs, RoPE's angles in float64 (the port
  draws its frequencies in float32, as the reference does), attention
  through the plain ``_direct_attention`` (the flash backward's
  accumulators are float32) and the embedding's plain autograd
  (``pb_embedding=False``);

and prints, for each sequence length, each float32 side's distance from
the float64 gradients and the two sides' distance from each other, leaf by
leaf as a share of the float64 leaf's max |g|, the worst leaves first, and
the operators of the float64 run that still made float32 tensors.

With ``--variants`` it also prints, each against the CPU's float64
gradients: the card in float64 (the same patches: does the card compute
the same function?), the card in float32 with plain attention in place
of the flash kernel, and with the embedding's plain autograd in place of
the rows kernel (does a kernel carry the gap?), and ``--probes`` CPU
float32 runs on weights each moved by half an ulp in a random direction
(how far float32-sized noise moves the float32 gradients: the
conditioning).

Reading: if the CPU's float32 gradients lie about as far from float64 as
the card's do, the card-vs-CPU gap is conditioning; if the CPU lies close
to float64 and the card far, the card's path carries an error of its own,
which the variants place.

Run on the card (about two minutes, five with the variants; 10 GB of
host memory):

    python3 scripts/torch_zamba2_witness.py [--seq 128 256] [--seed 18]
        [--variants] [--probes 3]
"""
import argparse
import collections
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def grads(model, cfg, batch):
    """{leaf: gradient on the CPU, float64} of the train loss on ``batch``."""
    import torch

    from repro_torch.train.steps import make_loss_fn

    dev = model.embed.table.device
    params = dict(model.named_parameters())
    loss = make_loss_fn(cfg)(model, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    g = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {n: t.detach().double().cpu() for n, t in zip(params, g)}


def variant_grads(model32, cfg32, batch, device, float64=False, plain_attention=False,
                  plain_embedding=False):
    """(loss, gradients, the operators that made float32 tensors) of a copy
    of ``model32`` on ``device``: in float64 as the module docstring says,
    or in float32 with plain attention or the plain embedding."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.models import layers as L
    from repro_torch.models.transformer import LM

    kw = dict(param_dtype="float64", compute_dtype="float64") if float64 else {}
    cfg = dataclasses.replace(cfg32, pb_embedding=not (float64 or plain_embedding), **kw)
    model = LM(cfg, device=device)
    model.load_state_dict(model32.state_dict())
    if float64:
        model.double()
    seen = collections.Counter()

    class Float32Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                   for t in tree_leaves(out)):
                seen[str(func)] += 1
            return out

    def attention(q, k, v, *, causal, q_block=512):
        return L._direct_attention(q, k, v, causal=causal, tile_f32=not float64)

    def rope(x, positions, theta):
        half = x.shape[-1] // 2
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
        ang = positions[..., None].double() * freqs
        while ang.ndim < x.ndim:
            ang = ang.unsqueeze(-2)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], -1)

    saved = torch.Tensor.float, L.blockwise_attention, L.rope
    if float64:
        torch.Tensor.float = lambda self, *a, **k: self.double()
        L.rope = rope
    if float64 or plain_attention:
        L.blockwise_attention = attention
    try:
        if float64:
            with Float32Ops():
                loss, g = grads(model, cfg, batch)
            assert all(t.dtype == torch.float64 for t in g.values())
        else:
            loss, g = grads(model, cfg, batch)
    finally:
        torch.Tensor.float, L.blockwise_attention, L.rope = saved
    return loss, g, dict(seen)


def float64_grads(model32, cfg32, batch):
    """The CPU's float64 run (module docstring)."""
    return variant_grads(model32, cfg32, batch, "cpu", float64=True)


def perturbed(model32, seed):
    """A copy of the CPU model ``model32`` whose every weight is moved by
    one float32 ulp in a random direction."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    model = copy.deepcopy(model32)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.randint(0, 2, p.shape, generator=gen).bool()
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf).to(p.dtype)))
    return model


def distance(a, b, truth):
    """{leaf: max |a - b| / max |truth|}."""
    return {n: float((a[n] - b[n]).abs().max() / (truth[n].abs().max() or 1.0)) for n in truth}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--seed", type=int, default=18)  # chip_smoke's FAM_SEED
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--probes", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import LM, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    base = get_config(args.arch)
    layers = base.attn_every if base.family == "hybrid" else 2
    cfg32 = dataclasses.replace(base, num_layers=layers, param_dtype="float32",
                                compute_dtype="float32")
    card = init_params(cfg32, seed=args.seed, device="cuda")
    cpu = LM(cfg32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    for S in args.seq:
        t = time.perf_counter()
        batch = SyntheticLM(DataConfig(vocab_size=cfg32.vocab_size, seq_len=S,
                                       global_batch=1)).batch_at(0)
        l_card, g_card = grads(card, cfg32, batch)
        l_cpu, g_cpu = grads(cpu, cfg32, batch)
        l64, g64, f32_ops = float64_grads(cpu, cfg32, batch)
        d_card, d_cpu = distance(g_card, g64, g64), distance(g_cpu, g64, g64)
        d_pair = distance(g_card, g_cpu, g64)
        worst = sorted(g64, key=lambda n: -d_pair[n])[:8]
        rec = {
            "arch": args.arch, "layers": layers, "tokens": S, "chunk": cfg32.mlstm_chunk,
            "loss": {"card": l_card, "cpu": l_cpu, "float64": l64},
            "card_vs_float64": max(d_card.values()), "cpu_vs_float64": max(d_cpu.values()),
            "card_vs_cpu": max(d_pair.values()),
            "worst_leaves": {n: {"card_vs_cpu": d_pair[n], "card_vs_float64": d_card[n],
                                 "cpu_vs_float64": d_cpu[n]} for n in worst},
            "float64_run_float32_ops": f32_ops}
        if args.variants:
            out = {}
            for name, kw in (("card_float64", dict(float64=True)),
                             ("card_plain_attention", dict(plain_attention=True)),
                             ("card_plain_embedding", dict(plain_embedding=True))):
                _, g, _ = variant_grads(card, cfg32, batch, "cuda", **kw)
                d = distance(g, g64, g64)
                out[name] = {"vs_float64": max(d.values()),
                             "worst": max(d, key=d.get)}
            rec["variants"] = out
        if args.probes:
            rec["cpu_one_ulp_vs_cpu"] = []
            rec["cpu_one_ulp_vs_float64"] = []
            for i in range(args.probes):
                _, g = grads(perturbed(cpu, i), cfg32, batch)
                rec["cpu_one_ulp_vs_cpu"].append(max(distance(g, g_cpu, g64).values()))
                rec["cpu_one_ulp_vs_float64"].append(max(distance(g, g64, g64).values()))
        rec.update(seconds=time.perf_counter() - t, card=smi)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
