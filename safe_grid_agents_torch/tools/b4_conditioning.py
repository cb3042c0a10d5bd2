"""Whether a long B4 check (``dqn_update`` held to its plain version over U
sequential updates) is well posed on given inputs: the plain version
against itself with each update's rows permuted (the same loss, summed in
another order), beside the kernel against the plain version.

    python -m safe_grid_agents_torch.tools.b4_conditioning \\
        [--case wide] [--seeds 0,1,2,3] [--updates 32,64,128,256] \\
        [--parent _archive/parent] [--platform cpu] [--out b4_conditioning.json]

For each seed, ``learner_cases.dqn_case(case)`` draws its inputs from a
generator with that seed; for each prefix of ``--updates`` updates, the
number of parameter, target, μ and ν entries beyond the check's tolerance
(rtol 2e-4, atol 1e-6) and the largest difference are printed for the
plain version with permuted rows, for this package's kernel and, with
``--parent``, for the kernel of the package under that root, each against
the plain version. Where the permuted plain version already leaves the
tolerance, the two orders of summation part on those inputs, and a kernel
that sums in a third order cannot be held to the tolerance there. With
``--platform cpu`` only the plain versions run, on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..ops import dqn_update_kernel as duk
from ..types import map_fields
from . import learner_cases as lc

RTOL, ATOL = 2e-4, 1e-6  # the B4 checks' tolerance (learner_cases.check_b4)


def beyond(got, want) -> tuple:
    """``(entries beyond the tolerance, largest |difference|)`` over the
    params, target, μ and ν of two ``dqn_update`` results."""
    n, m = 0, 0.0
    for a, b in zip(got[:4], want[:4]):
        for k in b:
            d = (a[k].to(b[k].device) - b[k]).abs()
            n += int((d > ATOL + RTOL * b[k].abs()).sum())
            m = max(m, float(d.max()))
    return n, m


def permute_rows(batch, seed: int):
    """The ``[U, B]`` batch with each update's B rows in another order."""
    U, B = batch.action.shape
    g = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(B, generator=g) for _ in range(U)]).to(
        batch.action.device)
    return map_fields(lambda t: torch.gather(t, 1, perm), batch)


def condition(case: str, seed: int, updates, dev, parent_duk=None) -> dict:
    """For each U of ``updates``: ``{"permuted": (n, max), "kernel": ...,
    "parent": ...}`` against the plain version (the kernels on a card
    only)."""
    agent, args = lc.dqn_case(case, dev, torch.Generator(device=dev).manual_seed(seed))
    head, batch = args[:6], args[6]
    permuted = permute_rows(batch, seed)
    out = {}
    for u in updates:
        cut = lambda b: map_fields(lambda t: t[:u].contiguous(), b)  # noqa: E731
        ref = duk.dqn_update_reference(agent, *head, cut(batch))
        row = {"permuted": beyond(duk.dqn_update_reference(agent, *head, cut(permuted)), ref)}
        if dev.type == "cuda":
            row["kernel"] = beyond(duk.dqn_update(agent, *head, cut(batch)), ref)
            if parent_duk is not None:
                row["parent"] = beyond(parent_duk.dqn_update(agent, *head, cut(batch)), ref)
        out[u] = row
        print(f"{case} seed {seed} U={u}: " + "; ".join(
            f"{k} {n} beyond, max |diff| {m:.3g}" for k, (n, m) in row.items()), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--case", default="wide")
    p.add_argument("--seeds", default="0,1,2,3")
    p.add_argument("--updates", default="32,64,128,256")
    p.add_argument("--parent", default=None,
                   help="root holding a second safe_grid_agents_torch package")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("b4_conditioning: no CUDA device is visible (--platform cpu runs "
                         "the plain versions alone)")
    dev = torch.device("cuda", 0) if args.platform == "cuda" else torch.device("cpu")
    parent_duk = None
    if args.parent and dev.type == "cuda":
        lc.load_package(args.parent, "sga_parent")
        parent_duk = lc.variant_ops("sga_parent")[0]
    updates = [int(u) for u in args.updates.split(",")]
    result = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "case": args.case, "seeds": {}}
    if dev.type == "cuda":
        result["card"] = lc.nvidia_smi("name,power.limit")
    for seed in (int(s) for s in args.seeds.split(",")):
        result["seeds"][seed] = condition(args.case, seed, updates, dev, parent_duk)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
