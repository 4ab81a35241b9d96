"""The decode kernels' single-CTA route at the served shapes (S = 1,088,
select_k 128: longchat-7b, granite-like, starcoder2-3b, zamba2-7b and
whisper-base rows; bf16 and int8 K/V; `chip_smoke.kernel_inputs` and
`chip_smoke.set_inputs`; ragged_decode and fused_decode with 4 blocks)
and their long route at `chip_smoke.LONG_SHAPES` (decode_32k and
long_500k rows, select_k 2,048, `chip_smoke.long_fills`;
`chip_smoke.kernel_inputs` and `chip_smoke.bits_inputs`): the outputs
saved, and the main shape's single-CTA times with L2 cold printed, so a
tree's routes can be held to another commit's bit for bit and in time.

On a card, from the root of each tree in turn (for another commit, an
unpacked `git archive` of it with this file copied in; its own
`chip_smoke.py` makes the inputs), then once to compare:

    PYTHONPATH=src python3 tools/single_cta_route.py save OUT.pt
    PYTHONPATH=src python3 tools/single_cta_route.py compare A.pt B.pt
"""
import itertools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def save(path):
    """Run both kernels at the served shapes, save their outputs to
    `path` and print the main shape's times with L2 cold."""
    c.build.build_all(["ragged_decode", "fused_decode"])
    gqa = [f for f in (1040, 1030, 1050, 690) for _ in range(8)]
    shapes = (("longchat", 128, 1, 128, c.MAIN_FILLS),
              ("granite-like", 32, 4, 64, gqa),
              ("starcoder2", 8, 12, 128, c.G12_FILLS),
              ("zamba2", 128, 1, 112, c.MAIN_FILLS),
              ("whisper", 32, 1, 64, c.WHISPER_FILLS))
    outs, times = {}, {}
    for (name, bh, g, d, fills), kv, make in itertools.product(
            shapes, (torch.bfloat16, torch.int8),
            (c.kernel_inputs, c.set_inputs)):
        fl, args = make(bh, g, d, 1088, fills, kv, seed=7)
        got = (*c.ragged_mod.ragged_decode(fl, *args, select_k=128),
               *c.fused_mod.fused_decode(*args, select_k=128, num_blocks=4))
        outs[f"{name} {str(kv)[6:]} {make.__name__}"] = [t.cpu() for t in got]
    for (name, bh, g, d, s), kv, make in itertools.product(
            c.LONG_SHAPES, (torch.bfloat16, torch.int8),
            (c.kernel_inputs, c.bits_inputs)):
        fl, args = make(bh, g, d, s, c.long_fills(bh, s, c.LONG_K, 7), kv,
                        seed=7)
        got = (*c.ragged_mod.ragged_decode(fl, *args, select_k=c.LONG_K),
               *c.fused_mod.fused_decode(*args, select_k=c.LONG_K,
                                         num_blocks=c.LONG_NB))
        outs[f"long route {name} {str(kv)[6:]} {make.__name__}"] = [
            t.cpu() for t in got]
        del fl, args, got
        torch.cuda.empty_cache()
    for kv in (torch.bfloat16, torch.int8):
        sets = [(f, *a) for f, a in (
            c.kernel_inputs(128, 1, 128, 1088, c.MAIN_FILLS, kv, seed=9 + i)
            for i in range(c.COLD_SETS))]
        times[f"ragged_decode {str(kv)[6:]}"] = c.cold_ms(
            lambda f, *a: c.ragged_mod.ragged_decode(f, *a, select_k=128),
            sets)
        times[f"fused_decode nb=4 {str(kv)[6:]}"] = c.cold_ms(
            lambda f, *a: c.fused_mod.fused_decode(*a, select_k=128,
                                                   num_blocks=4), sets)
    torch.save(outs, path)
    print(f"single-CTA route, main shape, ms with L2 cold: {times}  "
          f"[{c.smi_line()}]")


def compare(path_a, path_b):
    """Print whether two saved files hold the same bits, case by case."""
    a, b = torch.load(path_a), torch.load(path_b)
    differ = [k for k in a
              if not all(torch.equal(x, y) for x, y in zip(a[k], b[k]))]
    for route, mine in (("single-CTA",
                         lambda k: not k.startswith("long route")),
                        ("long", lambda k: k.startswith("long route"))):
        keys = [k for k in a if mine(k)]
        print(f"{route} route outputs bit-equal in "
              f"{len([k for k in keys if k not in differ])} of {len(keys)} "
              f"cases; differ: {[k for k in differ if mine(k)]}")
    return not differ


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"] and len(sys.argv) == 3:
        save(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    else:
        sys.exit(__doc__)
