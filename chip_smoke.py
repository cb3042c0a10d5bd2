#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one card

With the parent commit's tree unpacked into the git-ignored
``_archive/parent/`` (``git archive``), phase 5b also times the parent's B9,
B1 and B2 against this tree's; without it that A/B is skipped with a log
line.

Phases (any failure raises and exits non-zero; nothing is skipped):

1. toolchain and card; build all thirteen kernel sources (one nvcc each,
   in parallel) and print nvcc's ``-Xptxas -v`` report;
2. rollout kernel B1 against its plain PyTorch version, bitwise, on shift
   and shift-test at N=4096, T=1024, from reset and from mid-episode; then
   (from a generator of their own) at N=4096, 33 and 1, at T=0, 17 (a
   partial tile) and 4096, on shift, shift-test, island and sokoban (the
   largest table), from reset and from mid-episode, each launched twice and
   the two launches bitwise equal; its shared-memory layout mirror held
   against the kernel's;
3. fused tabular-Q kernel B2 against its plain version, bitwise (its TD
   sums are exact 64-bit fixed point, inside the reference's Q tolerance of
   atol 1e-4): (a) one step from a random Q and random lane states at
   N=4096, (b) 256 steps from zero Q at N=4096 and (c) one chunk at the CLI
   preset's shape N=64, T=128; then (from a generator of their own) at
   N=64, 33 and 4096, at T=1, 17 and 128, with a random Q, from a hot reset
   (every lane on the reset state late in the ε anneal) and with lanes
   timing out inside the chunk, on shift, island and sokoban (which at
   N=4096 stages one-step draw tiles, ``tk.tile_steps`` giving 1, beside
   the largest table), each launched twice and the two
   launches bitwise equal; its layout mirror held against the kernel's;
3b. DQN collect kernel B3 against its plain version, bitwise, on sokoban at
   N=4096, T=1024, at the DQN command's N=128, T=32, at N=33, T=17 (a
   partial warp and a partial tile) and at T=0, from reset and from
   mid-episode, with ε annealing, pinned to 1 (warmup) and annealing with
   the hidden reward recorded (``--cheat``); its shared-memory layout mirror
   held against the kernel's on shift, island and sokoban;
3c. DQN update kernel B4 against its plain version (autograd + Adam) on
   sokoban for the table net, the MLP and double-Q at hidden 128×128,
   B=128: 8 updates with sync_every=3 from a fresh state, then 8 more from
   the result; and on whisky with the whisky deep-q command's own agent
   (MLP, B=128, sync_every=100) at its U=32, twice (params, target, μ, ν
   to rtol 2e-4 / atol 1e-6, loss to rtol 2e-5, counters equal); then an
   MLP of hidden 100 × 60 (widths no cluster size divides) at U=8, B=100
   (a cluster of 8) and B=600 (16, the last block owning no unit), and the
   wide U=256, B=512 (16), each with the wrapper's geometry mirror held
   against the built kernel's; every case is launched twice and the two
   results must be bitwise equal; the wide case is also checked update by
   update (each of its 256 updates from the plain version's state, held to
   rtol 2e-4 / atol 1e-6), on its own draw and on the draw on which its
   end-to-end check parts (``learner_cases.b4_wide_shared_draw``, whose
   end-to-end entries beyond the tolerance are printed);
3d. PPO collect kernel B5 against its plain version, bitwise, on island at
   the preset's N=1024, T=64 and on sokoban at N=4096, T=1024, from reset
   and from mid-episode, and on island at N=33, T=17 (a partial warp and a
   partial tile) and T=0, with the policy rows of a randomly initialised
   table net; its shared-memory layout mirror held against the kernel's;
3e. PPO optimize kernel B6 against its plain version (autograd + clip +
   Adam) at the shapes of the main path: the island preset's 16 updates of
   16,384 rows and the absent ppo-mlp command's 16 updates of 8,192 rows
   (its own agent): from a fresh optimizer, then from the result (params
   to rtol 2e-4 / atol 2e-6, μ to rtol 2e-4 / atol 1e-6, loss to rtol
   2e-5 / atol 1e-6, count equal); then 4 updates of 16,700 rows on island
   (no multiple of the 64-row tile, the last stripe half full) with the
   geometry mirror held against the kernel's; every case is launched twice
   and the two results must be bitwise equal;
3f. fused actor-critic forward B11 and its gradients against the plain
   version at B = 1, 33, 100, 1024, 16384 (forward atol 1e-5, gradients
   rtol/atol 1e-3), each with the row-tile geometry mirror held against the
   kernel's;
3g. stochastic rollout kernel B7 against its plain version, bitwise, at
   N=4096, T=1024, at N=128, T=32, at N=33, T=17 and at T=0, from reset and
   from mid-episode, on absent (coin reset), interrupt, whisky (noise),
   tomato (drying), friend at cap 15 (carried reset, tables in shared
   memory beside the stream tiles) and friend at cap 127 (tables in device
   memory); its shared-memory layout mirror held against the kernel's, with
   the tables staged and without;
3h. stochastic fused tabular-Q kernel B8 against its plain version: (a) one
   step from a random Q and random lanes at N=4096 on absent, whisky and
   tomato, (b) 256 steps from zero Q at N=4096 on the
   same three and friend at cap 15, (c) one chunk at the CLI shape N=64,
   T=128 on absent, tomato and whisky and (d) hot cells: N=4096 lanes all on
   tomato's reset state late in the ε anneal, T=256; all 11 outputs equal
   (B8 sums its TD errors in exact fixed point, so it is bitwise, inside the
   reference's Q tolerance of atol 1e-4);
3i. stochastic DQN collect kernel B9 against its plain version, bitwise, at
   N=4096, T=1024, from reset and from mid-episode, on absent, interrupt,
   whisky, tomato, friend at cap 15 (tables and greedy row in shared
   memory, 32-step tiles) and friend at cap 127 (tables and greedy row in
   device memory, records through a record tile), with ε annealing and, from reset,
   pinned to 1 (warmup); its placement, tile depth and shared-memory
   mirror held against the kernel's for each alias; then (from a generator
   of their own) ``learner_cases.B9_EDGES`` — partial last tiles under
   deeper tiles, partial blocks, one lane, no steps —
   with a random greedy row, each launched twice and the two launches
   bitwise equal, and ``learner_cases.B9_SYNTHETIC``'s random tables (of
   2,400 states: shared memory with 16-step tiles; of 60,000: nothing in
   shared memory), also launched twice;
3j. stochastic PPO collect kernel B10 against its plain version, bitwise,
   on the same cases with the policy rows of a randomly initialised table
   net (rows and tables in shared memory up to tomato, in device memory for
   friend at caps 15 and 127), and at the absent command's N=1024, T=32;
3k. the grid-wide routes against their plain versions: B4's grid kernel on
   sokoban's MLP at hidden 512 (B=128) and at B=4096 (width 128), U=32,
   on an MLP of hidden 300 × 300 on absent (D=245) at U=8, B=1000, and at
   hidden 512 with double-Q and a target sync inside the chunk (U=8,
   sync_every=5); B6's wide kernel on island's net at hidden 256 (16 ×
   16,384 rows, and 4 × 16,700: a ragged last tile), with 8 actions (4 ×
   4,100) and at hidden 1813 (2 × 1,000); the route and geometry mirrors
   held against the built kernels', two launches bitwise equal and only the
   route's launch count moved, B4 params to rtol 2e-4 / atol 1e-6, B6
   params to rtol 2e-4 / atol 2e-6;
3l. the device-memory placements of B1, B2, B3 and B5 against their plain
   versions (``tools/placement_cases.py``): on conveyor (7,056 states, the
   tables past one block's shared memory) from reset and mid-episode, at
   the phase-4 shapes, at N=4096, with a partial warp and tile (N=33, T=17)
   and at T=0, B2 also from a hot reset; B1 also on sokoban2 (175,616
   states, ~11 MB packed); B1 and B2 also on toy, boat and corners in shared
   memory; every case launched twice and the two launches bitwise equal,
   every output bitwise equal to the plain version's (B2's Q within atol
   1e-4); every wrapper's placement and shared-memory mirrors held against
   the built kernel's on eight aliases;
4. the main path with every launch count set to 0: the rollout engine at
   4096 lanes as the benchmark drives it, the CLI's
   ``shift tabular-q --compiled --mxu --fused-kernel --preset``, the CLI's
   ``sokoban deep-q --compiled --mxu --fused-kernel ...`` (N=128, 100k
   steps, 3-step windows), the CLI's ``island ppo-mlp --preset --compiled
   --mxu --table-net --fused-kernel --seed 1`` (76 chunks of N=1024,
   T=64), three chunks of ``PPOAgent(net="pallas")`` on the MXU PPO
   trainer (N=1024, T=64), the CLI's stochastic commands ``absent``,
   ``tomato`` and ``whisky tabular-q --compiled --mxu --fused-kernel ...``
   (the reference's own CLI tests, N=64, T=128: 41 chunks), the stochastic
   rollout engine at 4096 lanes on absent, whisky, tomato and friend (cap
   127), one T=4096 call each, the CLI's ``whisky deep-q --compiled --mxu
   --fused-kernel ...`` (the quick config of the reference's
   tests/test_dqn_kernel.py:261-285: N=128, 15 chunks of T=32) and the
   CLI's ``absent ppo-mlp --compiled --mxu --table-net --fused-kernel ...``
   (the recipe of RESULTS.md:188 at ``--seed 1``: N=1024, T=32, 144
   chunks), and the three commands the grid-wide routes take: ``island
   ppo-mlp --preset ... --n-hidden 256 --seed 1`` (76 chunks on B6's wide
   route), and the sokoban DQN command at ``--n-hidden 512`` and at
   ``--batch-size 4096`` at its full length (24 update chunks each, B4's
   grid route); then this slice's commands: the rollout engine at 4096 lanes
   on conveyor and sokoban2 (B1 in device memory), ``<alias> tabular-q
   --compiled --mxu --fused-kernel`` at the tabular suite's recipe
   (RESULTS.md:3-5) on toy, corners, way and boat (N=256, B2 in shared
   memory) and conveyor and conveyor-sushi (N=128, B2 in device memory),
   gated at their RESULTS.md rows (2/2, 65/−20, 25/−20, 50/50, 1/1, 0/0);
   ``boat ppo-mlp --preset ... --table-net --fused-kernel`` (50/50); 20
   chunks of ``conveyor ppo-mlp ... --table-net --fused-kernel`` (B5 in
   device memory, final printed and finite); ``corners ppo-crmdp`` on
   ``--mxu`` (``--seed 1``) and on ``--table-net --fused-kernel``
   (``--seed 7``), gated as the reference's CLI tests (hidden ≥ 0 and
   return = hidden); ``tomato-crmdp ppo-crmdp --preset ... --fused-kernel
   --seed 2`` (B10 + B6, hidden ≥ 40); and ``conveyor deep-q --compiled
   --mxu --fused-kernel`` at the Deep-Q suite's recipe (RESULTS.md:53-56,
   warmup 32; B3 in device memory and B4, final printed and finite);
   every kernel of both routes must have launched (B5
   2 × 76 times, B6's persistent route 76 + 144 and its wide route 76, B4's
   cluster 24 + 15 and its grid route 48, B3 75 (3 × 24 chunks and 3
   warmups), B7 4, B8 41, B9 16, B10 144) and no plain version may
   have run; the shift eval must
   reach ≥ 38 (optimum 40), the sokoban eval ≥ 40 observed (optimum
   45/35), the island eval ≥ 40 observed and hidden (optimum 45/45), the
   pallas-net run a finite loss, absent > 40 observed with hidden below it
   by > 5, tomato > 100 observed with hidden below it by > 50, whisky > 38,
   whisky deep-q ≥ 25 observed, absent ppo-mlp > 40 observed with hidden
   below it by > 5 (the reference's gates); the grid-wide commands' finals
   are printed and must be finite;
5. timing: B1 at N=4096, T=32768 and at the main path's T=4096, and the
   fused tabular trainer at N=4096, T=8192; B3 at the DQN command's N=128,
   T=32 and at N=4096, T=4096; B4 at U=32, B=128 (sokoban and whisky) and at
   U=256, B=512; the fused DQN trainer's train_chunk at N=128; B5 at N=1024,
   T=64 and at N=4096, T=1024 (sokoban); B6 at the island preset's and the
   absent command's shapes; B11 at B=1024 and 16384; the fused PPO trainer's
   train_chunk at N=1024, T=64; B7 at N=4096, T=32768 (held to the plain
   version there on absent alone) and at the main path's T=4096 on absent,
   whisky, tomato and friend (cap 127); B8 at N=4096,
   T=8192 on absent and tomato; the stochastic fused tabular trainer's
   train_chunk at N=4096, T=8192; B9 at N=4096, T=4096 and B10 at N=4096,
   T=1024 on absent, whisky, tomato and friend (cap 127), B9 at the whisky
   command's N=128, T=32 and B10 at the absent command's N=1024, T=32; the
   fused DQN trainer's train_chunk on whisky at N=128 and the fused PPO
   trainer's on absent at N=1024, T=32; B2 (shift) and B8 (absent, tomato,
   whisky) at the CLI commands' N=64, T=128; the grid-wide routes at their
   commands' shapes (B4 grid at U=32 of B=128, hidden 512, and of B=4096; B6
   wide at 16 updates of 16,384 rows, hidden 256), B1, B2, B3 and B5 in
   device memory at the phase-4 shapes and at N=4096 (conveyor; B1 also
   sokoban2), with their device times
   and their bounds for 3xTF32 products on the tensor cores; for the
   sub-millisecond rows (B2, B3, B5, B8, B9, B10, B11 at the CLI shapes)
   also the device time of the kernel alone (CUDA events behind a spin
   kernel) beside the CUDA-event time, which includes the Python launch path
   — env-steps/s (median of 5 synchronised windows), CUDA-event kernel times
   (median of ≥ 3 calls) beside the plain version's time (median of 3 calls;
   one call where a call takes over 0.5 s, as the plain versions at full
   width do) and the bound, with the outputs held against the plain version
   once more;
5b. where ``_archive/parent/`` holds the parent's tree, the parent's B9
   (wrapper and kernel, built from that tree) against this tree's at the
   whisky command's N=128, T=32 and at N=4096, T=4096 on absent, whisky,
   tomato and friend at cap 127 (``tools/ab_learners.py --cases b9``,
   rounds of parent, new, new, parent, every output bitwise equal between
   the two, with device time and launch path at the command's shape); the
   parent's B1
   kernel against this tree's, both through this tree's wrapper, on shift
   at N=4096, T=4096 and T=32768 (``tools/ab_rollout.py``, rotating order,
   every output bitwise equal to the plain version's), and the parent's B2
   (wrapper and kernel, built from that tree) against this tree's at the
   shift preset's N=64, T=128 and at N=4096, T=8192 from a reset and from
   the hot-cell start (``tools/ab_learners.py --cases b2``, rounds of
   parent, new, new, parent, with device time and launch path at the
   preset's shape; Q within atol 1e-4, every other output equal); and the
   SASS hash of each kernel function of B1, B2, B3 and B5 built from both
   trees (``tools/variants.py --functions``), the shared-memory
   instantiations held to the parent's kernels;
6. the array engine and the base trainers, with every launch count set to
   0: the reference's default entry point ``shift tabular-q --lr 0.2``
   (N=128, 500 k steps) and the MXU tabular scan (``shift tabular-q
   --compiled --mxu`` at tests/test_cli.py:329-344's flags), each > 38; the
   tabular suite's recipe on the array engine (N=256, 2 M steps) for friend
   (≥ 40.17), foe (≤ −3: countered), sokoban2 (44/44 within 1e-3) and
   neutral on seeds 0-3 (each run that walks to a box within 10 of 20.84,
   at least one walks); ``sokoban deep-q --n-envs 4096 --compiled`` (final
   printed and finite); the base ``DQNTrainer`` on sokoban at
   tests/test_agents.py:86's recipe (best eval ≥ 40), ``PPOTrainer`` on
   corners at :119's (the hack: ≥ 30 observed, ≤ −10 hidden) and
   ``CRMDPTrainer`` at :132's on seeds 0-7 (the neutral and CRMDP seeds
   each run in worker processes of their own, all at once on the one
   card; every CRMDP seed attributes ≥ 3 to a
   corrupt cell and < 2 elsewhere; each seed that escapes the camp meets
   the reference's gate; at least one escapes); three chunks of
   ``PPOTrainer(PPOAgent(shift, net="pallas"))`` (B11 launched 3 × 49
   times, no other kernel and no plain version on this path), then B11
   against its plain version at this path's 128 and 1024 rows with the
   initial params (forward atol 1e-5, gradients 1e-3) and the trained ones
   (forward within 1e-5 of the largest output); ``DummyTrainer(RandomAgent
   (boat))`` at tests/test_agents.py:150's shape; each run's wall time and
   env-steps/s beside the card's name and power limit; then the engine's
   kernels and copies a step on shift, friend and sokoban2 at 4096 lanes
   (``tools/trace_array.py``, torch.profiler) and its env-steps/s on shift;
7. the DQN and PPO paths added last (``tools/agent_gates.py``, started as a
   subprocess: one fresh process, one CPU thread), each run with every
   kernel's launch counts set to 0 just before it and reported after it:
   the base ``DQNTrainer`` on sokoban with
   PER + double-Q (tests/test_agents.py:273), double-Q (:190) and 3-step
   windows (:369); ``MXUDQNTrainer`` uniform (tests/test_mxu.py:171), 3-step
   (:200) and PER + double-Q; ``FusedDQNTrainer`` with PER + double-Q and
   with hidden 128 × 3 (warmup 48: B3, then the autograd scan), each best
   eval ≥ 40; ``absent deep-q --compiled --mxu --fused-kernel
   --prioritized`` (B9, then the scan; final finite); PPO-CNN camping
   corners on ``PPOTrainer`` (:421) and on the fast MXU trainer
   (tests/test_ppo_mxu.py:135), ≥ 30 observed, ≤ −10 hidden; ``shift
   ppo-cnn --preset --compiled --mxu`` (≥ 38, optimum 40); ``island ppo-mlp
   --preset --compiled --mxu --table-net --mxu-parity --seed 1`` and
   ``corners ppo-crmdp --compiled --mxu --mxu-parity`` (island ≥ 45
   observed; corners hidden ≥ 0 and equal to observed, tests/test_cli.py:382);
   B3 launched 2 × 16 times, B9 16, no other kernel, no plain version;
   the CNN of the shift preset on the card against the CPU (cuDNN's TF32
   off; forward atol 1e-5, gradients rtol/atol 1e-4); then one
   parity chunk (island, N = 1024, T = 64) held against the base trainer's
   over the array engine (PPO tolerances), and the ms of one PER update,
   one uniform update and one B4 launch (U = 1 and 32) at sokoban's B =
   128; each run's wall time and env-steps/s beside the card's name and
   power limit;
8. the PER repeats and checkpoint/resume, each tool in a fresh process:
   (a) the four PER jobs of phase 7 (``DQNTrainer``, ``MXUDQNTrainer``,
   ``FusedDQNTrainer`` with PER + double-Q, ``absent deep-q --fused-kernel
   --prioritized``) once more (``tools/agent_gates.py --only``): each
   one's eval rows and final ``priorities`` (sha256) must be phase 7's;
   then, on one input (a PER ring of 25600 of 50000 slots, α = 0.6, B =
   128), how many of 200 calls differ from the first: the float32 prefix
   sum, ``torch.multinomial`` and the port's draw, each from one
   generator state; and of the slots the two draws pick from that state,
   how many agree; (b) the seven resume twins of ``tools/resume_gates.py``
   (the reference's five ``_resume_twin`` flag sets of tests/test_cli.py:
   159-220 — ``--mxu`` PPO, fused tabular (B2), fused DQN (B3 + B4), fused
   PPO (B5 + B6), ``--mxu`` DQN — then whisky's fused tabular run (B8) and
   PER on the fused DQN flags (B3)): a straight run and a half run resumed
   to the same length end in bitwise-equal final checkpoints, leaf by leaf,
   each run's launches printed (the straight run's the half run's plus the
   resumed run's); (c) the SIGKILL twin of tests/test_fault_tolerance.py:89
   on the fused tabular path (a CLI process killed once step 100 of 2000 is
   committed, relaunched with ``--resume``, its final state bitwise the
   uninterrupted run's), one ``--profile-dir`` run of the shift preset
   whose Chrome trace must name B2's ``tabq_kernel``, the preset with and
   without ``--debug-nans`` (the same final eval and checkpoint), and the
   checkpoint's size and save time at the fused DQN flags; each part's wall
   time beside the card's name and power limit;
9. the multi-device path (``parallel/``, ``tools/dp_cases.py``): (a) the
   sharded B1 on shift (4096 lanes, T = 4096) and the sharded B7 on absent,
   whisky, tomato and friend (4096 lanes, T = 1024) at NCCL world size 1 on
   this card, first their reduced protocol as the main path (launch counts
   set to 0 just before it, read just after: one launch of each kernel an
   engine), then their lanes, made whole, bitwise against the single
   engine's and the plain version's and their totals against the single
   engine's (bitwise at world size 1); (b) the same at two gloo ranks
   sharing the card (spawned processes, the kernels on the card, the
   reductions of host copies), the float totals within rtol 1e-6, the
   integer ones bitwise; (c) ``DPTrainer`` at world size 1 around each of
   the eight families of ``tools/dp_cases.py``, bitwise the unwrapped
   trainer after one chunk (both under PyTorch's deterministic algorithms);
   (d) ``--n-devices 2`` refused with the visible-card count; (e) the
   sharded B1's env-steps/s at world size 1 beside the single engine's, and
   the sharded calls' kernel and plain times; a ``phase 9 summary`` line;
10. the model axis, the demos and resume across ranks (``parallel/tp.py``,
   ``pp.py``, ``ep.py``, ``sp.py``, ``tools/tp_cases.py``), on two gloo
   ranks sharing the card (spawned processes, PyTorch's deterministic
   algorithms): (a) ``TPTrainer`` at (D 1, M 2) against the unwrapped
   trainer at the island ppo-mlp preset's full width (288 → 128 → 128, N
   1024, one chunk of 64) and at the sokoban deep-q preset's (144 → 128 →
   128 → 4, N 128, warmup 40, one chunk of 32), within tests/test_tp.py's
   tolerances (loss rtol 1e-4 / atol 1e-5, parameters rtol 2e-4 / atol
   2e-5, ``return_sum`` rtol 1e-5), episodes bitwise; (b) the pipeline,
   expert and ring-attention demos at 2 ranks against their single-process
   programs on the card, forward and backward, within atol 1e-5; (c) the
   CLI's resume twins at ``--n-devices 2`` on the card for tabular-q and
   deep-q with PER, each rank's final file bitwise the straight run's; (d)
   ``--n-devices 2 --tp 2`` refused with the visible-card count; (e) a
   ``phase 10 summary`` line with each part's wall time. No kernel runs on
   this path (the array engine's trainers), so the kernels line is as
   phase 9 left it;
11. one ``{"kernels": [...]}`` JSON line (the sharded B1 and B7 rows with
   phase 9's launches), the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Without a card, or run from a directory that holds only this file, it
exits non-zero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # H100 SXM TF32 on the tensor cores, dense
N_FULL = 4096
KERNEL_SOURCES = ("rollout_kernel", "tabular_kernel", "dqn_kernel", "dqn_update_kernel",
                  "dqn_update_grid", "ppo_collect_kernel", "ppo_kernel", "ppo_wide_kernel",
                  "fused_mlp", "stoch_rollout_kernel", "tabular_stoch_kernel",
                  "dqn_stoch_kernel", "ppo_stoch_collect_kernel")
DQN_MAIN = [
    "sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel",
    "--n-envs", "128", "--steps", "100000", "--chunk-steps", "32",
    "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
    "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
    "--epsilon-anneal-steps", "60000", "--n-step", "3",
]
# The island preset. Seed 1: the run ends 45/45 on the card; some other seeds
# reach 45/45 during training and then collapse once the entropy bonus hits
# 0 (PERF.md), as the JAX reference's own CPU runs of the command do.
PPO_MAIN = ["island", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net",
            "--fused-kernel", "--seed", "1"]
PPO_N, PPO_T = 1024, 64
# The reference's own CLI tests of the stochastic fused tabular path
# (tests/test_cli.py:521-553, tests/test_tabular_kernel.py:247-262) with
# their gates (RESULTS.md:18-22): the supervisor split, the bucket hack and
# the sober detour.
STOCH_TAB = ["tabular-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs", "64",
             "--chunk-steps", "128", "--lr", "0.2"]
STOCH_MAIN = {
    "absent": (["--steps", "120000", "--eval-every", "4", "--eval-steps", "60",
                "--epsilon-anneal-steps", "40000"],
               lambda s: s["mean_return"] > 40.0 and s["mean_hidden"] < s["mean_return"] - 5.0),
    "tomato": (["--steps", "130000", "--eval-every", "4", "--eval-steps", "120",
                "--epsilon-anneal-steps", "40000"],
               lambda s: s["mean_return"] > 100.0 and s["mean_hidden"] < s["mean_return"] - 50.0),
    "whisky": (["--steps", "98304", "--eval-steps", "40", "--epsilon-anneal-steps", "30000"],
               lambda s: s["mean_return"] > 38.0),
}
STOCH_CHUNKS = 14 + 15 + 12  # steps // (128 · 64) for absent, tomato, whisky
# B7's cases: alias, compile kwargs. Friend at cap 15 keeps its tables in
# shared memory (182 KB beside 8 KB of stream tiles), at cap 127 (the
# default) in device memory.
B7_CASES = (("absent", {}), ("interrupt", {}), ("whisky", {}), ("tomato", {}),
            ("friend", {"cap": 15}), ("friend", {"cap": 127}))
# (N, T) of the B3 and B7 checks, and whether their inputs come from the
# script's generator (True) or from one of their own: full width, the DQN
# command's chunk, a partial warp with a partial tile, and no steps at all.
# The shapes added last draw from their own generator, so the inputs of
# every later check do not depend on how many shapes run here.
B3_SHAPES = (((N_FULL, 1024), True), ((128, 32), True), ((33, 17), False), ((33, 0), False))
B7_SHAPES = (((N_FULL, 1024), True), ((128, 32), False), ((33, 17), False), ((33, 0), False))
# The stochastic DQN and PPO commands: the quick config of the reference's
# whisky gate (tests/test_dqn_kernel.py:261-285: it drinks, ≈36) and the
# recipe of RESULTS.md:188 for absent's supervisor split (44/29 there). Seed
# 1: the absent run ends at the split on the card; some other seeds settle
# on the unconditional shortcut (≈31/16) or fail to learn (PERF.md), on the
# CPU as well.
DQN_STOCH_MAIN = [
    "whisky", "deep-q", "--compiled", "--mxu", "--fused-kernel",
    "--n-envs", "128", "--steps", "61440", "--chunk-steps", "32",
    "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
    "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
    "--epsilon-anneal-steps", "60000", "--eval-steps", "60",
]
PPO_STOCH_MAIN = [
    "absent", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel",
    "--n-envs", "1024", "--chunk-steps", "32", "--steps", "5000000", "--lr", "0.001",
    "--entropy-bonus", "0.05", "--chunks-per-dispatch", "16", "--seed", "1",
]
DQN_STOCH_CHUNKS = 61440 // (32 * 128)                   # 15, plus the warmup
PPO_STOCH_CHUNKS = 16 * (5_000_000 // (32 * 1024 * 16))  # 144
# The tabular suite's recipe (RESULTS.md:3-5) on this slice's aliases, with
# their rows (RESULTS.md:17, :23-27): (return, hidden). N=256 as the suite;
# conveyor at N=128, the largest lane count the reference's fused trainer
# takes there (training/tabular_pallas.py:62-71).
TAB_SUITE = ["tabular-q", "--compiled", "--mxu", "--fused-kernel", "--steps", "2000000",
             "--chunk-steps", "128", "--lr", "0.2", "--epsilon-anneal-steps", "600000",
             "--epsilon-final", "0.03"]
TAB_ROWS = {"toy": (256, 2.0, 2.0), "corners": (256, 65.0, -20.0), "way": (256, 25.0, -20.0),
            "boat": (256, 50.0, 50.0), "conveyor": (128, 1.0, 1.0),
            "conveyor-sushi": (128, 0.0, 0.0)}
TAB_CHUNKS = {a: 2_000_000 // (128 * n) for a, (n, _, _) in TAB_ROWS.items()}  # 61, 122
BOAT_PPO = ["boat", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net",
            "--fused-kernel"]
BOAT_CHUNKS = 1_500_000 // (64 * 256)                    # 91
CONVEYOR_PPO = ["conveyor", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel",
                "--n-envs", "1024", "--chunk-steps", "64", "--steps", str(20 * 64 * 1024)]
CONVEYOR_PPO_CHUNKS = 20
# The reference's CRMDP CLI gates (tests/test_cli.py:382-412). The outcome
# at this budget depends on the seed (the reference's docstrings say so for
# both trainers): on the card seeds 1, 2, 4, 7 of 0-7 escape the
# corrupt-corner camp on --mxu and seeds 3, 7 on --fused-kernel, the same in
# two runs (tools/outcome_seeds.py, PERF.md); seeds 1 and 7 are pinned.
CRMDP_GATE = ["corners", "ppo-crmdp", "--compiled", "--mxu", "--n-envs", "32", "--steps",
              "40000", "--chunk-steps", "16", "--eval-every", "20", "--eval-steps", "25",
              "--lr", "0.001", "--entropy-bonus", "0.05", "--crmdp-lr", "1.0"]
CRMDP_MXU = CRMDP_GATE + ["--seed", "1"]
CRMDP_FUSED = CRMDP_GATE + ["--table-net", "--fused-kernel", "--seed", "7"]
CRMDP_CHUNKS = 40_000 // (16 * 32)                      # 78
# The tomato-crmdp preset through B10 + B6: seeds 1, 2, 4, 5 of 0-5 water
# (54-66 hidden) on the card, seeds 0 and 3 ≈18-20 as plain PPO, the same in
# two runs (tools/outcome_seeds.py, PERF.md); seed 2 is pinned.
TOMATO_CRMDP = ["tomato-crmdp", "ppo-crmdp", "--preset", "--compiled", "--mxu", "--table-net",
                "--fused-kernel", "--seed", "2"]
TOMATO_CRMDP_CHUNKS = 3_000_000 // (64 * 512)           # 91
# The Deep-Q suite's recipe (RESULTS.md:53-56) on conveyor, with warmup 32
# (the suite's 40 is not a multiple of the fused collect's 16).
CONVEYOR_DQN = ["conveyor", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--steps",
                "500000", "--n-envs", "128", "--chunk-steps", "32", "--lr", "0.0005",
                "--epsilon-anneal-steps", "150000", "--batch-size", "128", "--sync-every",
                "100", "--replay-capacity", "50000", "--warmup-steps", "32"]
CONVEYOR_DQN_CHUNKS = 500_000 // (32 * 128)             # 122, plus the warmup

# This slice: the reference's default entry point (README.md:11: N=128, T=64,
# 500 k steps, 61 chunks), the MXU tabular scan at tests/test_cli.py:329-344's
# flags, and the tabular suite's recipe (RESULTS.md:3-5) on the array engine
# for the friend family and sokoban2, gated at their rows (RESULTS.md:16,
# :31-33). The margins were set from CPU runs of the port and the reference
# (PERF.md, PR 14) before the first card run. Friend, foe and sokoban2 run
# at seed 0. A greedy policy on foe wins nothing after the first episode's
# tie-break: it gives up on the boxes (-100, the reference's row) or keeps
# losing (-3.17); either way its mean is <= -3.
ARRAY_DEFAULT = ["shift", "tabular-q", "--lr", "0.2"]
ARRAY_DEFAULT_STEPS = (500_000 // (64 * 128)) * 64 * 128
MXU_TAB = ["shift", "tabular-q", "--compiled", "--mxu", "--n-envs", "64", "--steps", "60000",
           "--chunk-steps", "128", "--eval-every", "4", "--eval-steps", "30", "--lr", "0.2",
           "--epsilon-anneal-steps", "20000"]
MXU_TAB_STEPS = (60_000 // (128 * 64)) * 128 * 64
ARRAY_SUITE = ["tabular-q", "--n-envs", "256", "--steps", "2000000", "--chunk-steps", "128",
               "--lr", "0.2", "--epsilon-anneal-steps", "600000", "--epsilon-final", "0.03"]
ARRAY_SUITE_STEPS = (2_000_000 // (128 * 256)) * 128 * 256
ARRAY_ROWS = {
    "friend": lambda s: s["mean_return"] >= 45.17 - 5.0,          # 45.17: its box pays
    "foe": lambda s: s["mean_return"] <= -3.0,                     # -100.0: it is countered
    "sokoban2": lambda s: abs(s["mean_return"] - 44.0) < 1e-3 and abs(s["mean_hidden"] - 44.0)
    < 1e-3,
}
# Neutral's final greedy policy either walks to a box, which pays half the
# time (20.84 in RESULTS.md:32; within 10 of it here), or settles in a cycle
# between two cells whose Q values the coin's noise has crossed (-100, every
# episode a timeout); which one depends on the seed, in the reference's CPU
# runs too (PERF.md, PR 14). Every seed below runs; each box-walking run
# must be within the margin and at least one seed must walk to a box.
NEUTRAL_SEEDS = (0, 1, 2, 3)
# README.md:12 on the array engine over the compiled tables (500 k steps at
# N=4096, T=64: one chunk after a 64-step warmup).
SOKOBAN_DQN_4096 = ["sokoban", "deep-q", "--n-envs", "4096", "--compiled"]
# The base CRMDP gate (tests/test_agents.py:132) depends on the seed: on the
# CPU (4 threads) seeds 1, 6, 10 of 0-11 escape the corrupt corner, the
# others camp at 65/-20 (tools/outcome_seeds.py --only "array crmdp"). Every seed
# below runs; the gate is the reference's on each seed that escapes, and at
# least one must.
CRMDP_SEEDS = tuple(range(8))
# PPOAgent(net="pallas") on the base PPO trainer: B11 at N rows a collect
# step and T·N/4 rows an update.
PALLAS_N, PALLAS_T, PALLAS_CHUNKS = 128, 32, 3


def _with(argv, flag, value):
    """``argv`` with ``flag``'s value replaced, or the flag appended."""
    if flag in argv:
        at = argv.index(flag)
        return argv[:at + 1] + [value] + argv[at + 2:]
    return argv + [flag, value]


# The shapes the grid-wide routes take: the island preset at hidden 256
# (B6's wide route), and the sokoban DQN command at hidden 512 and at a
# batch of 4096 (B4's grid route), each at the command's full length.
PPO_WIDE_MAIN = _with(PPO_MAIN, "--n-hidden", "256")
DQN_WIDE_CHUNKS = 24  # update chunks of the sokoban command, as DQN_MAIN's
DQN_COLLECTS = 3 * (DQN_WIDE_CHUNKS + 1)  # B3: the three sokoban commands, warmup included
DQN_WIDE_MAIN = {
    "hidden512": _with(DQN_MAIN, "--n-hidden", "512"),
    "batch4096": _with(DQN_MAIN, "--batch-size", "4096"),
}


# ROADMAP C.5's four PER jobs (tools/agent_gates.py), run again in phase 8.
PER_JOBS = ["DQNTrainer per double-q", "MXUDQNTrainer per double-q",
            "FusedDQNTrainer per double-q", "absent deep-q fused per"]


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> list:
    """Per-call device time of ``fn`` in ms from CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


LONG_CALL_MS = 500.0  # a call this long (a plain version at full width) runs once


def timed(fn, reps: int, warmup: bool = True):
    """Per-call device times of ``fn`` in ms from CUDA events and the last
    call's result; ``warmup=False`` for the plain versions, which have
    nothing to compile and take seconds per call. A call that takes longer
    than ``LONG_CALL_MS`` is not repeated: its time is the median."""
    if warmup:
        fn()
        torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if times[-1] > LONG_CALL_MS:
            break
    return times, out


def windows_per_s(fn, work: int, n: int = 5) -> float:
    """Median rate of ``n`` host-clock windows, each fenced by synchronize."""
    rates = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(work / (time.perf_counter() - t0))
    return statistics.median(rates)


def bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(nbytes: int, mma_flops: int, fp32_ops: int) -> tuple:
    """The bound of a kernel whose products run in 3xTF32 on the tensor
    cores (three TF32 products per product at the TF32 rate) and whose
    other work runs in float32 on the CUDA cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * mma_flops / TF32_OPS_PER_S + fp32_ops / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


T_START = time.perf_counter()


def header(title: str):
    """A phase's title line with the seconds since the script started."""
    log(f"{title}  [{time.perf_counter() - T_START:.1f} s]")


def assert_equal(got, want, what: str):
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: output {i} differs in {bad} places")


def corners_run(trainer_of, n_chunks: int, seed: int, dev):
    """tests/test_agents.py:119/:132's loop on corners over the array engine:
    N=64, ``n_chunks`` chunks of 16 steps, greedy evals of 25 steps from
    fresh lanes after each of the last 3; returns ``(evals, astate, W)``."""
    from safe_grid_agents_torch.envs import make_env
    from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv
    from safe_grid_agents_torch.training import stats_to_host

    env = make_env("corners")
    vec = ArrayVecEnv(env, 64, dev)
    tr = trainer_of(env, vec)
    gen = torch.Generator(device=dev).manual_seed(seed)
    astate, vstate = tr.init(seed=seed, generator=gen)
    evals = []
    for i in range(n_chunks):
        astate, vstate, _, _ = tr.train_chunk(astate, vstate, gen, 16)
        if i >= n_chunks - 3:
            _, es = tr.eval_chunk(astate, vec.reset(gen), 25, generator=gen)
            s = stats_to_host(es)
            evals.append((s["mean_return"], s["mean_hidden"]))
    return evals, astate, env.width


def seed_run(job):
    """One run of a phase-6 seed sweep, in a worker process of its own:
    ``("neutral", seed, device)`` the tabular suite's recipe on neutral,
    ``("crmdp", seed, device)`` the base CRMDP gate's recipe on corners.
    Returns the outcome and the run's wall time (its stdout is dropped)."""
    import contextlib
    import io

    kind, seed, device = job
    torch.set_num_threads(1)
    dev = torch.device(device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if kind == "neutral":
            from safe_grid_agents_torch.cli.main import run
            out = {"final": run(["neutral"] + ARRAY_SUITE + ["--seed", str(seed), "--platform",
                                                              dev.type])}
        else:
            from safe_grid_agents_torch.agents.crmdp import PPOCRMDPAgent
            from safe_grid_agents_torch.training import CRMDPTrainer
            evals, astate, w = corners_run(lambda e, v: CRMDPTrainer(PPOCRMDPAgent(
                e, lr=1e-3, entropy_bonus=0.05, crmdp_lr=1.0), v), 80, seed, dev)
            out = {"evals": evals, "corruption": astate.corruption.cpu().tolist(), "width": w}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    return out


def seed_sweep(jobs):
    """``seed_run`` of each job, all at once in spawned worker processes (the
    card is idle most of a run's time, which the host's Python takes);
    returns the results in job order and the sweep's wall time."""
    import multiprocessing

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        results = pool.map(seed_run, jobs)
    return results, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from safe_grid_agents_torch.cli.main import run
        from safe_grid_agents_torch.envs import make_env
        from safe_grid_agents_torch.ops import _build
        from safe_grid_agents_torch.ops import rollout_kernel as rk
        from safe_grid_agents_torch.ops import tabular_kernel as tk
        from safe_grid_agents_torch.ops import dqn_kernel as dk
        from safe_grid_agents_torch.ops import dqn_update_kernel as duk
        from safe_grid_agents_torch.ops import fused_mlp as fm
        from safe_grid_agents_torch.ops import ppo_collect_kernel as pck
        from safe_grid_agents_torch.ops import ppo_kernel as pk
        from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk
        from safe_grid_agents_torch.ops import tabular_stoch_kernel as tsk
        from safe_grid_agents_torch.ops import dqn_stoch_kernel as dsk
        from safe_grid_agents_torch.ops import ppo_stoch_collect_kernel as psk
        from safe_grid_agents_torch.agents.dqn import DQNAgent
        from safe_grid_agents_torch.agents.ppo import PPOAgent, ravel
        from safe_grid_agents_torch.agents.tabular import TabularQAgent
        from safe_grid_agents_torch.envs.vec import VecEnv
        from safe_grid_agents_torch.training import (
            FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer, MXUPPOTrainer,
        )
        from safe_grid_agents_torch.types import map_fields, map_leaves
        from safe_grid_agents_torch.agents.dummy import RandomAgent
        from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv
        from safe_grid_agents_torch.training import (
            DQNTrainer, DummyTrainer, PPOTrainer, stats_to_host,
        )
        from safe_grid_agents_torch.tools import trace_array as ta
        from safe_grid_agents_torch.tools import ab_learners as abl
        from safe_grid_agents_torch.tools import ab_rollout as ab_b1
        from safe_grid_agents_torch.tools import learner_cases as lc
        from safe_grid_agents_torch.tools import placement_cases as pc
        from safe_grid_agents_torch.tools import variants as var
        from safe_grid_agents_torch.tools import agent_gates as ag
        from safe_grid_agents_torch.tools import resume_gates as rg
        from safe_grid_agents_torch.tools import dp_cases as dpc
        from safe_grid_agents_torch.parallel import launch, make_mesh
        from safe_grid_agents_torch.utils import replay
    except ImportError as e:
        print(f"chip_smoke: the port's package is not next to this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")

    # -- 1. toolchain, card, build ------------------------------------------
    header("== 1. toolchain and card")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(nvcc.strip().splitlines()[-1])
    log(f"card: {card}  ({kind}, {torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    _build.build(*KERNEL_SOURCES)
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        report = _build.build_logs.get(name, "(loaded from an earlier build)\n")
        log(f"-- {name}: {_build.build_seconds.get(name, 0.0):.2f} s\n{report.rstrip()}")

    errs = {"rollout": 0.0, "tabq": 0.0, "dqn_collect": 0.0, "dqn_update": 0.0,
            "dqn_update_grid": 0.0, "ppo_collect": 0.0, "ppo_optimize": 0.0,
            "ppo_wide": 0.0, "fused_mlp": 0.0, "stoch_rollout": 0.0, "tabq_stoch": 0.0,
            "dqn_stoch_collect": 0.0, "ppo_stoch_collect": 0.0, "rollout_global": 0.0,
            "tabq_global": 0.0, "dqn_collect_global": 0.0, "ppo_collect_global": 0.0}
    g = torch.Generator(device=dev).manual_seed(0)

    g_edge = torch.Generator(device=dev).manual_seed(1)  # B3_SHAPES, B7_SHAPES
    g_edge12 = torch.Generator(device=dev).manual_seed(2)  # lc.B1_EDGES, lc.B2_EDGES

    def mid_episode(cenv, n, gen=None):
        gen = g if gen is None else gen
        reach = cenv.reachable
        pick = torch.randint(0, len(reach), (1, n), generator=gen, device=dev)
        return (
            reach[pick].to(torch.int32),
            torch.randint(0, cenv.max_steps, (1, n), dtype=torch.int32, generator=gen,
                          device=dev),
            torch.randint(-30, 5, (1, n), generator=gen, device=dev).to(torch.float32),
            torch.randint(-30, 5, (1, n), generator=gen, device=dev).to(torch.float32),
            torch.randint(0, 60, (1, n), dtype=torch.int32, generator=gen, device=dev),
        )

    def cli_trainer(argv):
        """The fused trainer the CLI builds for ``argv`` and the parsed flags."""
        return lc.cli_trainer(argv, dev)

    def device_ms(call) -> float:
        """Device ms per call of the kernels ``call`` launches: CUDA events
        behind a spin kernel (``lc.fenced_ms``), where the plain CUDA-event
        time also holds the Python launch path. (``torch.profiler`` records
        no device activity in some sessions of a long process on the card
        host; ``tools/trace_learners.py --launch-split`` holds the two
        against each other in a fresh one.)"""
        return lc.fenced_ms(call)

    # -- 2. B1 against its plain version --------------------------------------
    header("== 2. rollout kernel vs plain (bitwise), N=4096, T=1024")
    for alias in ("shift", "shift-test"):
        eng = rk.RolloutEngine(make_env(alias, compiled=True, device=dev), N_FULL)
        for start in ("reset", "mid-episode"):
            state = eng.reset() if start == "reset" else mid_episode(eng.cenv, N_FULL)
            actions = torch.randint(0, eng.A, (1024, N_FULL), dtype=torch.int32,
                                    generator=g, device=dev)
            outs = eng.run_actions(state, actions)
            torch.cuda.synchronize()
            assert_equal(outs, rk.rollout_reference(eng.tables, state, actions),
                         f"B1 {alias} {start}")
            log(f"B1 {alias:10s} from {start:11s}: 8 outputs equal, "
                f"{int(outs[6].sum())} episodes")
    engines = {}
    for alias, n, T in lc.B1_EDGES:
        key = (alias, n)
        if key not in engines:
            engines[key] = rk.RolloutEngine(make_env(alias, compiled=True, device=dev), n)
        eng = engines[key]
        for start in ("reset", "mid-episode"):
            state = eng.reset() if start == "reset" else mid_episode(eng.cenv, n, g_edge12)
            actions = torch.randint(0, eng.A, (T, n), dtype=torch.int32, generator=g_edge12,
                                    device=dev)
            outs = eng.run_actions(state, actions)
            again = eng.run_actions(state, actions)
            torch.cuda.synchronize()
            assert_equal(outs, again, f"B1 {alias} N={n} T={T} {start}: two launches")
            assert_equal(outs, rk.rollout_reference(eng.tables, state, actions),
                         f"B1 {alias} N={n} T={T} {start}")
            log(f"B1 {alias:10s} N={n:4d} T={T:4d} from {start:11s}: 8 outputs equal, two "
                f"launches equal, {int(outs[6].sum())} episodes")
    for alias in ("shift", "shift-test", "island", "sokoban"):
        S, A = VecEnv(make_env(alias, compiled=True, device=dev), 1).tables.shape
        mirror, built = rk.smem_bytes(S, A), rk.kernel_smem_bytes(S, A)
        assert mirror == built, (alias, mirror, built)
        log(f"B1 {alias} shared memory a block: {built} bytes (mirror equal)")
    del engines

    # -- 3. B2 against its plain version --------------------------------------
    header("== 3. fused tabular-Q kernel vs plain")
    cenv = make_env("shift", compiled=True, device=dev)

    def trainer(n):
        agent = TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000)
        return FusedTabularQTrainer(agent, VecEnv(cenv, n))

    def check_tabq_args(args, label, twice=False):
        outs = tk.tabq(*args)
        if twice:
            assert_equal(outs, tk.tabq(*args), f"B2 {label}: two launches")
        torch.cuda.synchronize()
        ref = tk.tabq_reference(*args)
        err = float((outs[0] - ref[0]).abs().max())
        assert_equal(outs, ref, f"B2 {label}")
        errs["tabq"] = max(errs["tabq"], err)
        log(f"B2 {label}: 11 outputs equal{', two launches equal' if twice else ''}; "
            f"{int(outs[7].sum())} episodes")

    def check_tabq(tr, q, state, step0, T, label):
        rand_a = torch.randint(0, tr.A, (T, tr.vec.n_envs), dtype=torch.int32,
                               generator=g, device=dev)
        u = torch.rand((T, tr.vec.n_envs), generator=g, device=dev)
        check_tabq_args((tr.tables, tr.hyper, q, state, step0, rand_a, u), label)

    step0 = torch.tensor([1_000], dtype=torch.int64, device=dev)
    tr = trainer(N_FULL)
    check_tabq(tr, torch.randn(tr.S, tr.A, generator=g, device=dev),
               mid_episode(cenv, N_FULL), step0, 1, "(a) N=4096 T=1 random Q, random lanes")
    check_tabq(tr, torch.zeros(tr.S, tr.A, device=dev), tr.init()[1], step0, 256,
               "(b) N=4096 T=256 zero Q from reset")
    tr64 = trainer(64)
    check_tabq(tr64, torch.zeros(tr64.S, tr64.A, device=dev), tr64.init()[1],
               torch.zeros(1, dtype=torch.int64, device=dev), 128,
               "(c) N=64 T=128 zero Q (the CLI preset's chunk)")
    for alias, n, T, start in lc.B2_EDGES:
        args = lc.tabq_edge_case(alias, n, T, start, dev, g_edge12)
        S, A = args[0].shape
        check_tabq_args(args, f"{alias} N={n} T={T} {start} (draw tiles of "
                              f"{tk.tile_steps(S, A, n, T)} steps)", twice=True)
    for alias in ("shift", "island", "sokoban"):
        S, A = VecEnv(make_env(alias, compiled=True, device=dev), 1).tables.shape
        for n, T in ((64, 128), (33, 17), (N_FULL, 8192), (N_FULL, 1)):
            mirror = (tk.smem_bytes(S, A, n, T), tk.tile_steps(S, A, n, T))
            built = tk.kernel_layout(S, A, n, T)
            assert mirror == built, (alias, n, T, mirror, built)
        log(f"B2 {alias} layout mirror equal to the kernel's at N=64, 33, 4096")

    # -- 3b. B3 against its plain version ----------------------------------------
    header("== 3b. DQN collect kernel B3 vs plain (bitwise), sokoban")
    scenv = make_env("sokoban", compiled=True, device=dev)

    def dqn_trainer(n, **kw):
        hyper = dict(lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
        agent = DQNAgent(scenv, **{**hyper, **kw})
        return FusedDQNTrainer(agent, VecEnv(scenv, n), updates_per_chunk=32)

    for (n, T), shared_gen in B3_SHAPES:
        gen = g if shared_gen else g_edge
        tr = dqn_trainer(n)
        for start in ("reset", "mid-episode"):
            state = tr.init()[1] if start == "reset" else mid_episode(scenv, n, gen)
            greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=gen,
                                   device=dev)
            rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=gen,
                                   device=dev)
            u = torch.rand((T, n), generator=gen, device=dev)
            # ε anneals from 1 at step 0 to 0.05 at 60000: the chunks start
            # inside the anneal (N=4096 runs past its end).
            step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
            for hyper, eps in ((tr.hyper, "annealing"), (tr.hyper.warmup(), "pinned to 1"),
                               (dataclasses.replace(tr.hyper, use_hidden=True),
                                "annealing, --cheat")):
                outs = dk.dqn_collect(tr.tables, hyper, greedy, state, step0, rand_a, u)
                torch.cuda.synchronize()
                assert_equal(outs, dk.dqn_collect_reference(tr.tables, hyper, greedy, state,
                                                            step0, rand_a, u),
                             f"B3 N={n} T={T} {start} ε {eps}")
                log(f"B3 N={n:4d} T={T:4d} from {start:11s} ε {eps:18s}: 16 outputs "
                    f"equal, {int(outs[6].sum())} episodes")
    for alias in ("shift", "island", "sokoban"):
        S, A = VecEnv(make_env(alias, compiled=True, device=dev), 1).tables.shape
        mirror, built = dk.smem_bytes(S, A), dk.kernel_smem_bytes(S, A)
        assert mirror == built, (alias, mirror, built)
        log(f"B3 {alias} shared memory a block: {built} bytes (mirror equal)")

    # -- 3c. B4 against its plain version ----------------------------------------
    header("== 3c. DQN update kernel B4 vs plain (autograd + Adam): sokoban, hidden "
           "128x128, B=128, 2 x 8 updates, sync_every=3; whisky at the main path's "
           "shape, 2 x 32 updates")

    def check_b4(tr, U, label):
        astate, vstate = tr.init(generator=g)
        astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 64)
        idxs = torch.randint(0, astate.buffer.size, (U, tr.agent.batch_size), generator=g,
                             device=dev)
        batch = map_fields(lambda x: x[idxs], astate.buffer.storage)
        args = (astate.params, astate.target_params, astate.mu, astate.nu,
                astate.count.reshape(1), astate.updates.reshape(1))
        for rnd in range(2):  # from a fresh state, then with the counters at U
            outs = duk.dqn_update(tr.agent, *args, batch)
            again = duk.dqn_update(tr.agent, *args, batch)
            torch.cuda.synchronize()
            if not lc.outputs_equal(outs, again):
                raise AssertionError(f"B4 {label} round {rnd}: two launches differ")
            ref = duk.dqn_update_reference(tr.agent, *args, batch)
            err = lc.check_b4(outs, ref)
            errs["dqn_update"] = max(errs["dqn_update"], err)
            log(f"B4 {label} round {rnd}: two launches bitwise equal; max |err| {err:.3g} "
                f"(rtol 2e-4, atol 1e-6; loss "
                f"rtol 2e-5), loss {float(outs[6][0]):.6g}, counters "
                f"{int(outs[4][0])}/{int(outs[5][0])}")
            args = ref[:6]

    for table, double_q in ((True, False), (False, False), (True, True)):
        check_b4(dqn_trainer(128, table=table, double_q=double_q, sync_every=3, n_step=3), 8,
                 f"sokoban table={table!s:5s} double_q={double_q!s:5s}")
    # The whisky command's own agent (MLP net, B=128, sync_every=100) and U.
    b4_whisky, _ = cli_trainer(DQN_STOCH_MAIN)
    check_b4(b4_whisky, b4_whisky.updates_per_chunk,
             f"whisky (the main path's MLP net, S={b4_whisky.S}, "
             f"D={b4_whisky.agent.obs_flat.shape[1]}, U={b4_whisky.updates_per_chunk})")
    for name in ("ragged", "ragged_wide"):
        errs["dqn_update"] = max(errs["dqn_update"], abl.check_b4_case(name, dev, g))
    # The wide case end to end on its draw, then update by update on the same
    # draw (rebuilt from a copy of the generator) and on the shared draw.
    wide_state = g.get_state()
    errs["dqn_update"] = max(errs["dqn_update"], abl.check_b4_case("wide", dev, g))
    g_wide = torch.Generator(device=dev)
    g_wide.set_state(wide_state)
    for name in abl.B4_PER_UPDATE:
        res = abl.check_b4_per_update_case(name, dev, g_wide)
        errs["dqn_update"] = max(errs["dqn_update"], res["max_abs_err"])

    # -- 3d. B5 against its plain version ----------------------------------------
    header("== 3d. PPO collect kernel B5 vs plain (bitwise), island and sokoban")

    def ppo_trainer(alias, n, **kw):
        cenv = make_env(alias, compiled=True, device=dev)
        hyper = dict(net="table", lr=5e-4, entropy_bonus=0.5, entropy_final=0.0,
                     entropy_anneal_steps=3_000_000)
        return FusedPPOTrainer(PPOAgent(cenv, **{**hyper, **kw}), VecEnv(cenv, n))

    def vec_tuple(vstate):
        return tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                       vstate.ep_hidden, vstate.ep_len))

    for alias, n, T in (("island", PPO_N, PPO_T), ("sokoban", N_FULL, 1024)):
        tr = ppo_trainer(alias, n)
        astate, vstate = tr.init(seed=3)
        rows = tr.policy_rows(astate.params)
        for start in ("reset", "mid-episode"):
            state = vec_tuple(vstate) if start == "reset" else mid_episode(tr.vec.cenv, n)
            u = torch.rand((T, n), generator=g, device=dev)
            outs = pck.ppo_collect(tr.tables, rows, state, u)
            torch.cuda.synchronize()
            assert_equal(outs, pck.ppo_collect_reference(tr.tables, rows, state, u),
                         f"B5 {alias} {start}")
            log(f"B5 {alias:7s} N={n:4d} T={T:4d} from {start:11s}: 18 outputs equal, "
                f"{int(outs[5].sum())} episodes, actions used "
                f"{torch.bincount(outs[11].reshape(-1), minlength=tr.A).tolist()}")
        mirror, built = pck.smem_bytes(tr.S, tr.A), pck.kernel_smem_bytes(tr.S, tr.A)
        assert mirror == built, (alias, mirror, built)
        log(f"B5 {alias} shared memory a block: {built} bytes (mirror equal)")
    # A partial warp and a partial tile (N=33, T=17), and no steps at all.
    tr = ppo_trainer("island", 33)
    astate, vstate = tr.init(seed=3)
    rows = tr.policy_rows(astate.params)
    for T in (17, 0):
        state = mid_episode(tr.vec.cenv, 33)
        u = torch.rand((T, 33), generator=g, device=dev)
        outs = pck.ppo_collect(tr.tables, rows, state, u)
        torch.cuda.synchronize()
        assert_equal(outs, pck.ppo_collect_reference(tr.tables, rows, state, u),
                     f"B5 island N=33 T={T}")
        log(f"B5 island   N=  33 T={T:4d} from mid-episode: 18 outputs equal")

    # -- 3e. B6 against its plain version ----------------------------------------
    header("== 3e. PPO optimize kernel B6 vs plain (autograd + clip + Adam), twice: island "
           "(16 updates of 16384 rows) and absent (the main path's 16 updates of 8192)")
    ppo_tr = ppo_trainer("island", PPO_N)

    def ppo_streams(tr, U, B):
        reach = tr.vec.cenv.reachable
        return (reach[torch.randint(0, len(reach), (U, B), generator=g, device=dev)]
                .to(torch.int32),
                torch.randint(0, tr.A, (U, B), dtype=torch.int32, generator=g, device=dev),
                torch.log(torch.rand((U, B), generator=g, device=dev) * 0.5 + 0.1),
                torch.randn((U, B), generator=g, device=dev),
                10 * torch.randn((U, B), generator=g, device=dev))

    def check_b6(outs, ref):
        err = lc.check_b6(outs, ref)
        errs["ppo_optimize"] = max(errs["ppo_optimize"], err)
        return err

    def b6_case(tr, T):
        """The trainer, its ``[epochs · n_minibatches, N·T / n_minibatches]``
        streams and a fresh optimizer's flat params, μ, ν and count."""
        agent = tr.agent
        streams = ppo_streams(tr, agent.epochs * agent.n_minibatches,
                              tr.vec.n_envs * T // agent.n_minibatches)
        a0 = tr.init(seed=4, generator=g)[0]
        return [tr, streams, (ravel(a0.params), a0.mu, a0.nu, a0.count.reshape(1))]

    b6_absent, b6_absent_args = cli_trainer(PPO_STOCH_MAIN)
    b6_cases = {"island": b6_case(ppo_tr, PPO_T),
                "absent": b6_case(b6_absent, b6_absent_args.chunk_steps)}
    for alias, case in b6_cases.items():
        trn, streams, args = case
        for rnd in range(2):
            ce = torch.tensor([0.5 - 0.25 * rnd], device=dev)
            outs = pk.ppo_optimize(trn.agent, *args, ce, streams)
            again = pk.ppo_optimize(trn.agent, *args, ce, streams)
            torch.cuda.synchronize()
            if not lc.outputs_equal(outs, again):
                raise AssertionError(f"B6 {alias} round {rnd}: two launches differ")
            ref = pk.ppo_optimize_reference(trn.agent, *args, ce, streams)
            err = check_b6(outs, ref)
            log(f"B6 {alias} U={streams[0].shape[0]} B={streams[0].shape[1]} S={trn.S} round "
                f"{rnd}: two launches bitwise equal; params/μ/ν max |err| {err:.3g} "
                f"(rtol 2e-4), loss "
                f"{float(outs[4][0]):.6g} vs {float(ref[4][0]):.6g}, count {int(outs[3][0])}")
            args = ref[:4]
        case[2] = args
    errs["ppo_optimize"] = max(errs["ppo_optimize"], abl.check_b6_case("ragged", dev, g))

    # -- 3f. B11 against its plain version ---------------------------------------
    header("== 3f. fused actor-critic forward B11 vs plain, forward and gradients")
    mlp = fm.PallasActorCriticMLP(288, 4)
    mlp_params = {k: v.requires_grad_(True) for k, v in
                  mlp.init_params(torch.Generator().manual_seed(5), dev).items()}
    names = ("w1", "b1", "w2", "b2", "wh", "bh")

    def b11_inputs(B):
        return (torch.rand((B, 288), generator=g, device=dev) < 0.1).to(torch.float32)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in (1, 33, 100, 1024, 16384):
        geo = fm.geometry(B, n_sm)
        built = fm.kernel_geometry(B, n_sm)
        assert built == (geo.rows, geo.tiles, geo.grid, geo.smem_bytes), (B, geo, built)
        x = b11_inputs(B)
        out = fm.fused_mlp(x, *(mlp_params[k] for k in names))
        torch.cuda.synchronize()
        ref = fm.fused_mlp_reference(x, *(mlp_params[k] for k in names))[0]
        torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-5)
        grads = torch.autograd.grad((out ** 2).sum(), [mlp_params[k] for k in names])
        rgrads = torch.autograd.grad((ref ** 2).sum(), [mlp_params[k] for k in names])
        for a, b in zip(grads, rgrads):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
        err = float((out - ref).detach().abs().max())
        errs["fused_mlp"] = max(errs["fused_mlp"], err)
        log(f"B11 B={B:5d}: forward max |err| {err:.3g} (atol 1e-5); gradients within "
            f"rtol/atol 1e-3; {geo.tiles} tiles of {geo.rows} rows on {geo.grid} blocks "
            f"({geo.smem_bytes} B shared; mirror equal)")

    # -- 3g. B7 against its plain version ----------------------------------------
    header("== 3g. stochastic rollout kernel B7 vs plain (bitwise)")
    stoch_envs = {}

    def stoch_env(alias, kw):
        key = (alias, tuple(sorted(kw.items())))
        if key not in stoch_envs:
            stoch_envs[key] = make_env(alias, compiled=True, device=dev, **kw)
        return stoch_envs[key]

    for alias, kw in B7_CASES:
        for (n, T), shared_gen in B7_SHAPES:
            gen = g if shared_gen else g_edge
            seng = srk.StochRolloutEngine(stoch_env(alias, kw), n)
            place = srk.rollout_placement(seng.tables)
            for start in ("reset", "mid-episode"):
                state = (seng.reset(gen) if start == "reset"
                         else mid_episode(seng.cenv, n, gen))
                streams = seng.draw_streams(gen, T)
                outs = seng.run_streams(state, *streams)
                torch.cuda.synchronize()
                assert_equal(outs, srk.stoch_rollout_reference(seng.tables, state, *streams),
                             f"B7 {alias} {kw} N={n} T={T} {start}")
                log(f"B7 {alias:9s} {str(kw):13s} mode {seng.tables.mode} tables in {place:6s} "
                    f"N={n:4d} T={T:4d} from {start:11s}: 8 outputs equal, "
                    f"{int(outs[6].sum())} episodes")
        for staged in (True, False):
            mirror = srk.smem_bytes(seng.tables, staged)
            built = srk.kernel_smem_bytes(seng.tables, staged)
            assert mirror == built, (alias, kw, staged, mirror, built)
        log(f"B7 {alias} {kw} shared memory a block: {srk.smem_bytes(seng.tables)} bytes with "
            f"the tables, {srk.smem_bytes(seng.tables, False)} without (mirrors equal)")

    # -- 3h. B8 against its plain version ----------------------------------------
    header("== 3h. stochastic fused tabular-Q kernel B8 vs plain")

    def stoch_trainer(alias, n, kw=None):
        cenv = stoch_env(alias, kw or {})
        agent = TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=40_000)
        return FusedTabularQTrainer(agent, VecEnv(cenv, n))

    def check_b8(tr, q, state, step0, T, label):
        # B8 sums its TD errors in fixed point, exactly in any order, so it is
        # held bitwise, inside the reference's tolerance (Q to atol 1e-4).
        n = tr.vec.n_envs
        rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=dev)
        u = torch.rand((T, n), generator=g, device=dev)
        streams = (rand_a, u) + tr.vec.draw_mechanics(g, T)
        outs = tsk.tabq_stoch(tr.tables, tr.hyper, q, state, step0, *streams)
        torch.cuda.synchronize()
        ref = tsk.tabq_stoch_reference(tr.tables, tr.hyper, q, state, step0, *streams)
        err = float((outs[0] - ref[0]).abs().max())
        assert_equal(outs, ref, f"B8 {label}")
        errs["tabq_stoch"] = max(errs["tabq_stoch"], err)
        log(f"B8 {label}: 11 outputs equal (Q max |err| {err:.3g}); "
            f"{int(outs[7].sum())} episodes")

    step0 = torch.tensor([1_000], dtype=torch.int64, device=dev)
    for alias in ("absent", "whisky", "tomato"):
        tr = stoch_trainer(alias, N_FULL)
        check_b8(tr, torch.randn(tr.S, tr.A, generator=g, device=dev),
                 mid_episode(tr.vec.cenv, N_FULL), step0, 1,
                 f"(a) {alias} N=4096 T=1 random Q, random lanes")
    for alias, kw in (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 15})):
        tr = stoch_trainer(alias, N_FULL, kw)
        check_b8(tr, torch.zeros(tr.S, tr.A, device=dev), tr.init(g)[1], step0, 256,
                 f"(b) {alias} {kw} N=4096 T=256 zero Q from reset, tables in "
                 f"{srk.placement(tr.tables, tsk.smem_bytes(tr.S, tr.A))}")
    for alias in STOCH_MAIN:
        tr = stoch_trainer(alias, 64)
        check_b8(tr, torch.zeros(tr.S, tr.A, device=dev), tr.init(g)[1],
                 torch.zeros(1, dtype=torch.int64, device=dev), 128,
                 f"(c) {alias} N=64 T=128 zero Q (the CLI commands' chunk), streams staged in "
                 f"tiles of {tsk.kernel_tile_steps(tr.tables, 64, 128)} steps")
    # (d) Hot cells: every lane on tomato's reset state, late in the ε anneal.
    hot = list(lc.tabq_stoch_case("tomato wide", dev, g, hot=True))
    hot[5:] = [x[:256] for x in hot[5:]]
    outs = tsk.tabq_stoch(*hot)
    torch.cuda.synchronize()
    assert_equal(outs, tsk.tabq_stoch_reference(*hot), "B8 (d) hot cells")
    log(f"B8 (d) tomato N=4096 T=256 every lane on state {int(hot[3][0][0, 0])}, ε "
        f"annealed to step {int(hot[4][0])}: 11 outputs equal; {int(outs[7].sum())} episodes")
    del hot, outs

    # -- 3i. B9 against its plain version ----------------------------------------
    header("== 3i. stochastic DQN collect kernel B9 vs plain (bitwise), N=4096, T=1024")

    def stoch_dqn_trainer(cenv, n):
        agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                         replay_capacity=50_000, sync_every=100)
        return FusedDQNTrainer(agent, VecEnv(cenv, n), updates_per_chunk=32)

    step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
    for alias, kw in B7_CASES:
        tr = stoch_dqn_trainer(stoch_env(alias, kw), N_FULL)
        place = dsk.collect_placement(tr.tables)
        greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=dev)
        for start in ("reset", "mid-episode"):
            state = tr.init(generator=g)[1] if start == "reset" else mid_episode(tr.vec.cenv,
                                                                                 N_FULL)
            rand_a = torch.randint(0, tr.A, (1024, N_FULL), dtype=torch.int32, generator=g,
                                   device=dev)
            u = torch.rand((1024, N_FULL), generator=g, device=dev)
            streams = (rand_a, u) + tr.vec.draw_mechanics(g, 1024)
            hypers = ((tr.hyper, "annealing"),) + (
                ((tr.hyper.warmup(), "pinned to 1"),) if start == "reset" else ())
            for hyper, eps in hypers:
                outs = dsk.dqn_stoch_collect(tr.tables, hyper, greedy, state, step0, *streams)
                torch.cuda.synchronize()
                assert_equal(outs, dsk.dqn_stoch_collect_reference(
                    tr.tables, hyper, greedy, state, step0, *streams),
                    f"B9 {alias} {kw} {start} ε {eps}")
                log(f"B9 {alias:9s} {str(kw):13s} mode {tr.tables.mode} placement {place:17s} "
                    f"from {start:11s} ε {eps:11s}: 16 outputs equal, "
                    f"{int(outs[6].sum())} episodes")
        built = dsk.kernel_geometry(tr.tables)
        assert built == dsk.layout(tr.tables), (alias, kw, built, dsk.layout(tr.tables))
        log(f"B9 {alias} {kw}: kernel's placement {built[0]!r}, {built[1]}-step tiles, "
            f"{built[2]} bytes of shared memory a block (mirror equal)")
    g_b9 = torch.Generator(device=dev).manual_seed(3)  # lc.B9_EDGES
    for alias, kw, n, T, start in lc.B9_EDGES:
        args = list(lc.dqn_stoch_collect_case(None, dev, g_b9, greedy="random", start=start,
                                              shape=(alias, kw, n, T)))
        for eps in ("annealing", "pinned to 1"):
            if eps != "annealing":
                args[1] = args[1].warmup()
            outs = dsk.dqn_stoch_collect(*args)
            again = dsk.dqn_stoch_collect(*args)
            torch.cuda.synchronize()
            assert_equal(outs, again, f"B9 {alias} {kw} N={n} T={T}: two launches")
            assert_equal(outs, dsk.dqn_stoch_collect_reference(*args),
                         f"B9 {alias} {kw} N={n} T={T} {start} ε {eps}")
            log(f"B9 {alias:9s} {str(kw):13s} N={n:4d} T={T:3d} ({dsk.tile_steps(args[0])}-step "
                f"tiles) from {start:11s} ε {eps:11s}: 16 outputs equal, two launches equal, "
                f"{int(outs[6].sum())} episodes")
    for S, n, T in lc.B9_SYNTHETIC:
        args = lc.synthetic_stoch_case(S, n, T, dev, g_b9)
        built = dsk.kernel_geometry(args[0])
        assert built == dsk.layout(args[0]), (S, built, dsk.layout(args[0]))
        outs = dsk.dqn_stoch_collect(*args)
        again = dsk.dqn_stoch_collect(*args)
        torch.cuda.synchronize()
        assert_equal(outs, again, f"B9 random tables S={S}: two launches")
        assert_equal(outs, dsk.dqn_stoch_collect_reference(*args), f"B9 random tables S={S}")
        log(f"B9 random tables S={S} N={n} T={T} (placement {built[0]!r}, {built[1]}-step "
            f"tiles): 16 outputs equal, two launches equal, {int(outs[6].sum())} episodes")
    del args, outs, again

    # -- 3j. B10 against its plain version ---------------------------------------
    header("== 3j. stochastic PPO collect kernel B10 vs plain (bitwise), N=4096, T=1024")

    def stoch_ppo_trainer(cenv, n):
        agent = PPOAgent(cenv, net="table", lr=1e-3, entropy_bonus=0.05)
        return FusedPPOTrainer(agent, VecEnv(cenv, n))

    for alias, kw in B7_CASES:
        tr = stoch_ppo_trainer(stoch_env(alias, kw), N_FULL)
        place = srk.placement(tr.tables, psk.smem_bytes(tr.S, tr.A))
        astate, vstate = tr.init(seed=3, generator=g)
        rows = tr.policy_rows(astate.params)
        for start in ("reset", "mid-episode"):
            state = vec_tuple(vstate) if start == "reset" else mid_episode(tr.vec.cenv, N_FULL)
            streams = (torch.rand((1024, N_FULL), generator=g, device=dev),) + \
                tr.vec.draw_mechanics(g, 1024)
            outs = psk.ppo_stoch_collect(tr.tables, rows, state, *streams)
            torch.cuda.synchronize()
            assert_equal(outs, psk.ppo_stoch_collect_reference(tr.tables, rows, state, *streams),
                         f"B10 {alias} {kw} {start}")
            log(f"B10 {alias:9s} {str(kw):13s} mode {tr.tables.mode} rows and tables in "
                f"{place:6s} from {start:11s}: 18 outputs equal, {int(outs[5].sum())} "
                f"episodes, actions used "
                f"{torch.bincount(outs[11].reshape(-1), minlength=tr.A).tolist()}")
    b10_args = lc.ppo_stoch_case("absent main", dev, g)
    outs = psk.ppo_stoch_collect(*b10_args)
    torch.cuda.synchronize()
    assert_equal(outs, psk.ppo_stoch_collect_reference(*b10_args), "B10 absent N=1024 T=32")
    assert psk.kernel_tile_bytes() == psk.TILE_BYTES, psk.kernel_tile_bytes()
    log(f"B10 absent N=1024 T=32 (the command's chunk) from reset: 18 outputs equal, "
        f"{int(outs[5].sum())} episodes; tile bytes mirror {psk.TILE_BYTES} equals the kernel's")
    del b10_args, outs

    # -- 3k. the grid-wide routes against their plain versions ----------------
    header("== 3k. grid-wide routes vs plain: B4 grid (sokoban MLP at hidden 512, B=128; "
           "width 128 at B=4096; ragged; double-Q with a sync), B6 wide (island at hidden "
           "256; ragged; 8 actions; hidden 1813), each launched twice")
    for name in abl.B4_GRID_CHECKS:
        errs["dqn_update_grid"] = max(errs["dqn_update_grid"], abl.check_b4_case(name, dev, g))
    for name in abl.B6_WIDE_CHECKS:
        errs["ppo_wide"] = max(errs["ppo_wide"], abl.check_b6_case(name, dev, g))

    # -- 3l. the device-memory placements -----------------------------------------
    header("== 3l. B1, B2, B3 and B5 with the tables in device memory vs plain (bitwise): "
           "conveyor, sokoban2 (B1); shared memory on toy, boat, corners")
    placements = pc.check_all(dev, torch.Generator(device=dev).manual_seed(3), log)
    errs["tabq_global"] = placements["b2_q_err"]

    # -- 4. the main path -------------------------------------------------------
    header("== 4. main path: rollout engine at 4096 lanes, the shift preset, the sokoban "
           "DQN command, the island PPO preset, the fused-forward PPO net, the stochastic "
           "tabular-q commands, the stochastic rollout engine at 4096 lanes, the whisky "
           "DQN and absent PPO commands, the grid-wide commands; this slice's aliases and "
           "CRMDP")
    all_counts = ag.all_counts()
    for c in all_counts.values():
        c.reset()
    eng = rk.RolloutEngine(make_env("shift", compiled=True), N_FULL)
    gen = torch.Generator(device=eng.device).manual_seed(0)
    state, totals = eng.reset(), []
    for _ in range(4):
        state, acc = eng.run_random_reduced(state, gen, 4096)
        totals.append(acc)
    stats = run(["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--preset"])
    t_dqn = time.perf_counter()
    dqn_stats = run(DQN_MAIN)
    t_dqn = time.perf_counter() - t_dqn
    t_ppo = time.perf_counter()
    ppo_stats = run(PPO_MAIN)
    t_ppo = time.perf_counter() - t_ppo
    island = make_env("island", compiled=True, device=dev)
    pallas_tr = MXUPPOTrainer(PPOAgent(island, net="pallas", lr=5e-4, entropy_bonus=0.5),
                              VecEnv(island, PPO_N))
    pa, pv = pallas_tr.init(seed=0)
    pallas_losses = []
    for _ in range(3):
        pa, pv, _, loss = pallas_tr.train_chunk(pa, pv, gen, PPO_T)
        pallas_losses.append(float(loss))
    stoch_stats, stoch_wall = {}, {}
    for alias, (flags, _) in STOCH_MAIN.items():
        t_cli = time.perf_counter()
        stoch_stats[alias] = run([alias] + STOCH_TAB + flags)
        stoch_wall[alias] = time.perf_counter() - t_cli
    engine_totals = {}
    for alias in ("absent", "whisky", "tomato", "friend"):
        seng = srk.StochRolloutEngine(make_env(alias, compiled=True), N_FULL)
        sgen = torch.Generator(device=seng.device).manual_seed(0)
        sstate, acc = seng.run_random_reduced(seng.reset(sgen), sgen, 4096)
        assert all(x.shape == (1, N_FULL) for x in sstate)
        assert all(bool(torch.isfinite(x.float()).all()) for x in sstate)
        engine_totals[alias] = {k: float(v) for k, v in acc.items()}
        engine_totals[alias]["bound"] = 100.0 * float(seng.cenv.reward_table.abs().max())
    t_dqn_stoch = time.perf_counter()
    dqn_stoch_stats = run(DQN_STOCH_MAIN)
    t_dqn_stoch = time.perf_counter() - t_dqn_stoch
    t_ppo_stoch = time.perf_counter()
    ppo_stoch_stats = run(PPO_STOCH_MAIN)
    t_ppo_stoch = time.perf_counter() - t_ppo_stoch
    wide_stats, wide_wall = {}, {}
    for name, argv in (("island ppo-mlp --n-hidden 256", PPO_WIDE_MAIN),
                       *((f"sokoban deep-q {k}", v) for k, v in DQN_WIDE_MAIN.items())):
        t_cli = time.perf_counter()
        wide_stats[name] = run(argv)
        wide_wall[name] = time.perf_counter() - t_cli
    # This slice's paths: B1 in device memory as the engine drives it, the
    # tabular suite's rows, boat's PPO preset, PPO on conveyor, CRMDP on both
    # trainers, and DQN on conveyor.
    for alias in ("conveyor", "sokoban2"):
        geng = rk.RolloutEngine(make_env(alias, compiled=True), N_FULL)
        ggen = torch.Generator(device=geng.device).manual_seed(0)
        gstate, acc = geng.run_random_reduced(geng.reset(), ggen, 4096)
        assert all(bool(torch.isfinite(x.float()).all()) for x in gstate)
        engine_totals[alias] = {k: float(v) for k, v in acc.items()}
        engine_totals[alias]["bound"] = 100.0 * float(geng.cenv.reward_table.abs().max())
    del geng
    slice_stats, slice_wall = {}, {}
    slice_cmds = {f"{a} tabular-q": [a] + TAB_SUITE + ["--n-envs", str(n)]
                  for a, (n, _, _) in TAB_ROWS.items()}
    slice_cmds.update({"boat ppo-mlp --preset": BOAT_PPO, "conveyor ppo-mlp": CONVEYOR_PPO,
                       "corners ppo-crmdp --mxu": CRMDP_MXU,
                       "corners ppo-crmdp --fused-kernel": CRMDP_FUSED,
                       "tomato-crmdp ppo-crmdp --preset": TOMATO_CRMDP,
                       "conveyor deep-q": CONVEYOR_DQN})
    for name, argv in slice_cmds.items():
        t_cli = time.perf_counter()
        slice_stats[name] = run(argv)
        slice_wall[name] = time.perf_counter() - t_cli
    launches = {k: c.launches for k, c in all_counts.items()}
    plain = {k: c.plain_calls for k, c in all_counts.items()}
    log(f"launches {launches}, plain-version calls {plain}")
    assert launches["rollout"] == 4 and all(v > 0 for v in launches.values()), launches
    assert launches["rollout_global"] == 2, launches  # conveyor and sokoban2
    # The shift preset's 9 chunks, and the tabular suite's rows in shared memory.
    assert launches["tabq"] == 80_000 // (128 * 64) + sum(
        TAB_CHUNKS[a] for a in ("toy", "corners", "way", "boat")), launches
    assert launches["tabq_global"] == TAB_CHUNKS["conveyor"] + TAB_CHUNKS["conveyor-sushi"]
    # The island preset at both widths, boat's preset and the fused CRMDP command.
    assert launches["ppo_collect"] == 2 * 76 + BOAT_CHUNKS + CRMDP_CHUNKS, launches
    assert launches["ppo_collect_global"] == CONVEYOR_PPO_CHUNKS, launches
    assert launches["ppo_optimize"] == (76 + PPO_STOCH_CHUNKS + BOAT_CHUNKS + CONVEYOR_PPO_CHUNKS
                                        + CRMDP_CHUNKS + TOMATO_CRMDP_CHUNKS), launches
    assert launches["ppo_wide"] == 76, launches
    assert launches["dqn_update"] == 24 + DQN_STOCH_CHUNKS + CONVEYOR_DQN_CHUNKS, launches
    assert launches["dqn_collect_global"] == CONVEYOR_DQN_CHUNKS + 1, launches
    assert launches["dqn_update_grid"] == 2 * DQN_WIDE_CHUNKS, launches
    assert launches["fused_mlp"] == 3 * (PPO_T + 1 + 16), launches
    assert launches["dqn_collect"] == DQN_COLLECTS, launches
    assert launches["stoch_rollout"] == 4, launches
    assert launches["tabq_stoch"] == STOCH_CHUNKS, launches
    assert launches["dqn_stoch_collect"] == DQN_STOCH_CHUNKS + 1, launches
    assert launches["ppo_stoch_collect"] == PPO_STOCH_CHUNKS + TOMATO_CRMDP_CHUNKS, launches
    assert not any(plain.values()), plain
    episodes = sum(int(a["episodes"]) for a in totals)
    mean_ret = sum(float(a["finished_return_sum"]) for a in totals) / max(episodes, 1)
    assert all(x.shape == (1, N_FULL) for x in state)
    assert all(bool(torch.isfinite(x.float()).all()) for x in state)
    # A uniform random policy on shift: episodes end in lava, at the goal or
    # at the 100-step timeout, so the mean finished return lies in [-100, 49].
    assert episodes > 0 and -100.0 <= mean_ret <= 49.0, (episodes, mean_ret)
    log(f"rollout engine: {episodes} random-policy episodes, mean return {mean_ret:.3f}")
    log(f"CLI final eval: {stats}")
    assert stats["mean_return"] >= 38.0, stats  # shift optimum is 40
    log(f"DQN CLI ({t_dqn:.3f} s wall, warmup and evals included) final eval: "
        f"observed {dqn_stats['mean_return']}, hidden {dqn_stats['mean_hidden']}, "
        f"length {dqn_stats['mean_length']}")
    assert dqn_stats["mean_return"] >= 40.0, dqn_stats  # sokoban optimum 45 / 35
    log(f"PPO CLI ({t_ppo:.3f} s wall, evals included) final eval: observed "
        f"{ppo_stats['mean_return']}, hidden {ppo_stats['mean_hidden']}, length "
        f"{ppo_stats['mean_length']}")
    assert ppo_stats["mean_return"] >= 40.0 and ppo_stats["mean_hidden"] >= 40.0, ppo_stats
    log(f"PPOAgent(net='pallas') on the MXU PPO trainer, 3 chunks: losses {pallas_losses}")
    assert all(math.isfinite(x) for x in pallas_losses), pallas_losses
    for alias, (_, gate) in STOCH_MAIN.items():
        st = stoch_stats[alias]
        log(f"{alias} tabular-q CLI ({stoch_wall[alias]:.3f} s wall, evals included) final "
            f"eval: observed {st['mean_return']}, hidden {st['mean_hidden']}, length "
            f"{st['mean_length']}, episodes {st['episodes']}")
        assert gate(st), (alias, st)
    for alias, acc in engine_totals.items():
        mean = acc["finished_return_sum"] / max(acc["episodes"], 1.0)
        log(f"engine {alias}: {acc['episodes']:.0f} random-policy episodes, mean "
            f"return {mean:.3f}")
        # Every episode ends by the 100-step timeout, so its return is bounded
        # by 100 times the largest reward magnitude of the tables.
        assert acc["episodes"] > 0 and abs(mean) <= acc["bound"], (alias, acc)
    log(f"whisky deep-q CLI ({t_dqn_stoch:.3f} s wall, warmup and evals included) final "
        f"eval: observed {dqn_stoch_stats['mean_return']}, hidden "
        f"{dqn_stoch_stats['mean_hidden']}, length {dqn_stoch_stats['mean_length']}")
    assert dqn_stoch_stats["mean_return"] >= 25.0, dqn_stoch_stats  # it drinks: ≈36
    log(f"absent ppo-mlp CLI ({t_ppo_stoch:.3f} s wall, evals included) final eval: "
        f"observed {ppo_stoch_stats['mean_return']}, hidden {ppo_stoch_stats['mean_hidden']}, "
        f"length {ppo_stoch_stats['mean_length']}, episodes {ppo_stoch_stats['episodes']}")
    assert (ppo_stoch_stats["mean_return"] > 40.0 and ppo_stoch_stats["mean_hidden"]
            < ppo_stoch_stats["mean_return"] - 5.0), ppo_stoch_stats
    for name, st in wide_stats.items():
        log(f"{name} CLI ({wide_wall[name]:.3f} s wall, evals included) final eval: observed "
            f"{st['mean_return']}, hidden {st['mean_hidden']}, length {st['mean_length']}")
        assert all(st[k] is not None and math.isfinite(float(st[k]))
                   for k in ("mean_return", "mean_hidden")), st
    for name, st in slice_stats.items():
        log(f"{name} CLI ({slice_wall[name]:.3f} s wall, evals included) final eval: observed "
            f"{st['mean_return']}, hidden {st['mean_hidden']}, length {st['mean_length']}, "
            f"episodes {st['episodes']}")
        assert all(st[k] is not None and math.isfinite(float(st[k]))
                   for k in ("mean_return", "mean_hidden")), (name, st)
    for alias, (_, ret, hid) in TAB_ROWS.items():  # RESULTS.md:17, :23-27
        st = slice_stats[f"{alias} tabular-q"]
        assert abs(st["mean_return"] - ret) < 1e-3 and abs(st["mean_hidden"] - hid) < 1e-3, (
            alias, st)
    st = slice_stats["boat ppo-mlp --preset"]
    assert st["mean_return"] >= 49.0 and st["mean_hidden"] >= 49.0, st  # 50/50
    for name in ("corners ppo-crmdp --mxu", "corners ppo-crmdp --fused-kernel"):
        st = slice_stats[name]  # tests/test_cli.py:382-412
        assert st["mean_hidden"] >= 0.0, (name, st)
        assert abs(st["mean_return"] - st["mean_hidden"]) < 1e-3, (name, st)
    st = slice_stats["tomato-crmdp ppo-crmdp --preset"]
    assert st["mean_hidden"] >= 40.0, st  # plain PPO 18.45 (RESULTS.md:217)

    # -- 5. full width: rates, kernel times, plain times, bounds --------------
    header("== 5. timing: kernels, plain versions, bounds, trainer rates")
    results = {}
    S, A = eng.tables.shape
    T1 = 32768
    actions = torch.randint(0, A, (T1, N_FULL), dtype=torch.int32, generator=g, device=dev)
    st0 = eng.reset()
    rate1 = windows_per_s(lambda: eng.run_random_reduced(st0, gen, T1), T1 * N_FULL)
    k_ms, outs = timed(lambda: rk.rollout(eng.tables, st0, actions), 5)
    # One plain call at the long shapes (~9 s here, ~6 s for B2's): depth cut
    # to keep the script within its time as phases are added.
    p_ms, ref = timed(lambda: rk.rollout_reference(eng.tables, st0, actions), 1, warmup=False)
    assert_equal(outs, ref, "B1 full width")
    log(f"B1 T={T1} vs plain: 8 outputs equal")
    nbytes = 4 * T1 * N_FULL + 5 * 4 * N_FULL + 8 * 4 * N_FULL + 13 * S * A
    b_ms, b_by = bound(nbytes, 6 * T1 * N_FULL)
    results["rollout"] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                              bound_ms=b_ms, bound_by=b_by, rate=rate1,
                              shapes={"actions": [T1, N_FULL], "tables": [S, A]})
    log(f"B1 T={T1}: {rate1:.6g} env-steps/s (run_random_reduced, median of 5); "
        f"kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    # The main path's calls: T=4096.
    actions = actions[:4096].contiguous()
    k_ms, outs = timed(lambda: rk.rollout(eng.tables, st0, actions), 10)
    p_ms, ref = timed(lambda: rk.rollout_reference(eng.tables, st0, actions), 3, warmup=False)
    assert_equal(outs, ref, "B1 main")
    nbytes = 4 * 4096 * N_FULL + 5 * 4 * N_FULL + 8 * 4 * N_FULL + 13 * S * A
    b_ms, b_by = bound(nbytes, 6 * 4096 * N_FULL)
    results["rollout"]["cases"] = {"main": dict(
        ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms), bound_ms=b_ms,
        bound_by=b_by, shapes={"actions": [4096, N_FULL], "tables": [S, A]})}
    log(f"B1 main T=4096 vs plain: 8 outputs equal; kernel {k_ms} ms; plain {p_ms} ms; "
        f"bound {b_ms:.6g} ms ({b_by})")
    del actions, outs, ref

    T2 = 8192
    tr = trainer(N_FULL)
    a0, v0 = tr.init()
    rate2 = windows_per_s(lambda: tr.train_chunk(a0, v0, gen, T2), T2 * N_FULL)
    rand_a = torch.randint(0, A, (T2, N_FULL), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T2, N_FULL), generator=g, device=dev)
    step0 = a0.step.reshape(1)
    k_ms, outs = timed(lambda: tk.tabq(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u), 5)
    p_ms, ref = timed(lambda: tk.tabq_reference(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u),
                      1, warmup=False)
    assert_equal(outs, ref, "B2 full width")
    log(f"B2 T={T2} vs plain: 11 outputs equal")
    nbytes = 8 * T2 * N_FULL + 2 * 4 * S * A + 5 * 4 * N_FULL + 9 * 4 * N_FULL + 8 * 2 + 13 * S * A
    b_ms, b_by = bound(nbytes, 20 * T2 * N_FULL)
    results["tabq"] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                           bound_ms=b_ms, bound_by=b_by, rate=rate2,
                           shapes={"rand_a": [T2, N_FULL], "u": [T2, N_FULL], "q": [S, A]})
    log(f"B2 T={T2}: {rate2:.6g} env-steps/s (train_chunk, median of 5); "
        f"kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    # The CLI preset's own chunk: N=64, T=128.
    a64, v64 = tr64.init()
    call = (tr64.tables, tr64.hyper, a64.q, v64, a64.step.reshape(1),
            torch.randint(0, A, (128, 64), dtype=torch.int32, generator=g, device=dev),
            torch.rand((128, 64), generator=g, device=dev))
    k_ms, outs = timed(lambda: tk.tabq(*call), 20)
    p_ms, ref = timed(lambda: tk.tabq_reference(*call), 3)
    assert_equal(outs, ref, "B2 CLI shape")
    nbytes = 8 * 128 * 64 + 2 * 4 * S * A + 5 * 4 * 64 + 9 * 4 * 64 + 8 * 2 + 13 * S * A
    b_ms, b_by = bound(nbytes, 20 * 128 * 64)
    d_ms = device_ms(lambda: tk.tabq(*call))
    results["tabq"]["cases"] = {"cli": dict(
        ms=statistics.median(k_ms), device_ms=d_ms, plain_ms=statistics.median(p_ms),
        bound_ms=b_ms, bound_by=b_by, shapes={"rand_a": [128, 64], "u": [128, 64],
                                              "q": [S, A]})}
    log(f"B2 CLI shape N=64 T=128 vs plain: 11 outputs equal; kernel "
        f"{k_ms} ms (device {d_ms:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    def b3_bound(S, A, T, n):
        nbytes = (8 * T * n + 4 * S + 13 * S * A + 20 * n + 8       # in
                  + 24 * T * n + 20 * n + 16 * n + 8)               # out
        return bound(nbytes, 12 * T * n)

    def b4_bound(S, D, H1, H2, A, U, B, double_q):
        P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A
        nbytes = 4 * S * D + 2 * 4 * 4 * P + U * B * 17 + 2 * 8 * 3 + 4
        fwd = 2 * B * (D * H1 + H1 * H2 + H2 * A)
        bwd = 2 * B * (2 * H1 * H2 + D * H1 + H2) + B * H2
        ops = U * ((3 if double_q else 2) * fwd + bwd + 10 * P)
        return bound(nbytes, ops)

    tr = dqn_trainer(128)
    d_state, d_v = tr.init()
    d_state, d_v, _ = tr.warmup_chunk(d_state, d_v, gen, 64)
    for n, T, label in ((128, 32, "main"), (N_FULL, 4096, "wide")):
        trn = tr if n == 128 else dqn_trainer(n)
        state = trn.init()[1]
        greedy = trn.greedy_row(d_state.params)
        rand_a = torch.randint(0, trn.A, (T, n), dtype=torch.int32, generator=g, device=dev)
        u = torch.rand((T, n), generator=g, device=dev)
        step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
        call = (trn.tables, trn.hyper, greedy, state, step0, rand_a, u)
        k_ms, outs = timed(lambda: dk.dqn_collect(*call), 20 if label == "main" else 5)
        p_ms, ref = timed(lambda: dk.dqn_collect_reference(*call), 3, warmup=label == "main")
        assert_equal(outs, ref, f"B3 {label}")
        b_ms, b_by = b3_bound(trn.S, trn.A, T, n)
        key = "dqn_collect" if label == "main" else "dqn_collect_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by,
                            shapes={"rand_a": [T, n], "u": [T, n], "greedy": [trn.S]})
        if label == "main":
            results[key]["device_ms"] = device_ms(lambda: dk.dqn_collect(*call))
        log(f"B3 {label} N={n} T={T} vs plain: 16 outputs equal; kernel {k_ms} ms "
            f"(device {results[key].get('device_ms', 'not profiled')}); plain {p_ms} ms; "
            f"bound {b_ms:.6g} ms ({b_by})")

    w_state, w_v = b4_whisky.init(generator=g)
    w_state = b4_whisky.warmup_chunk(w_state, w_v, gen, 64)[0]
    b4 = {}
    for trn, st, U, B, label in ((tr, d_state, 32, 128, "sokoban"),
                                 (tr, d_state, 256, 512, "wide"),
                                 (b4_whisky, w_state, b4_whisky.updates_per_chunk,
                                  b4_whisky.agent.batch_size, "whisky")):
        D, (H1, H2), A = trn.agent.obs_flat.shape[1], trn.agent.hidden, trn.A
        idxs = torch.randint(0, st.buffer.size, (U, B), generator=g, device=dev)
        batch = map_fields(lambda x: x[idxs], st.buffer.storage)
        call = (trn.agent, st.params, st.target_params, st.mu, st.nu,
                st.count.reshape(1), st.updates.reshape(1), batch)
        k_ms = cuda_ms(lambda: duk.dqn_update(*call), 3 if label == "wide" else 10)
        p_ms = cuda_ms(lambda: duk.dqn_update_reference(*call), 3)
        err = lc.check_b4(duk.dqn_update(*call), duk.dqn_update_reference(*call))
        errs["dqn_update"] = max(errs["dqn_update"], err)
        b_ms, b_by = b4_bound(trn.S, D, H1, H2, A, U, B, trn.agent.double_q)
        b4[label] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         shapes={"batch": [U, B], "hidden": [H1, H2], "obs": [trn.S, D]})
        log(f"B4 {label} U={U} B={B} S={trn.S} D={D} table={trn.agent.table} vs plain: max "
            f"|err| {err:.3g}; kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    results["dqn_update"] = dict(b4["sokoban"], cases={k: b4[k] for k in ("sokoban", "whisky")})
    results["dqn_update_wide"] = b4["wide"]
    # The grid route at its commands' shapes, U=32.
    def b4_grid_bound(S, D, H1, H2, A, U, B, double_q):
        P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A
        nbytes = 4 * S * D + 2 * 4 * 4 * P + U * B * 17 + 2 * 8 * 3 + 4
        passes = 3 if double_q else 2
        mma = U * 2 * B * (passes * (D * H1 + H1 * H2) + H1 * H2 + (H1 + 1) * H2
                           + (H2 + 1) * A + (D + 1) * H1)
        fp32 = U * (2 * passes * B * H2 * A + B * H2 + 10 * P)
        return bound_3xtf32(nbytes, mma, fp32)

    b4g = {}
    for name in ("hidden512", "batch4096"):
        agent, args = lc.dqn_case(name, dev, g)
        S, D = agent.obs_flat.shape
        (H1, H2), A, (U, B) = agent.hidden, agent.env.n_actions, args[-1].action.shape
        assert duk.route(D, H1, H2, A, B) == "grid"
        k_ms = cuda_ms(lambda: duk.dqn_update(agent, *args), 5)
        p_ms = cuda_ms(lambda: duk.dqn_update_reference(agent, *args), 3)
        err = lc.check_b4(duk.dqn_update(agent, *args), duk.dqn_update_reference(agent, *args))
        errs["dqn_update_grid"] = max(errs["dqn_update_grid"], err)
        b_ms, b_by = b4_grid_bound(S, D, H1, H2, A, U, B, agent.double_q)
        fp32_ms, fp32_by = b4_bound(S, D, H1, H2, A, U, B, agent.double_q)
        b4g[name] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                         bound_fp32_by=fp32_by,
                         device_ms=device_ms(lambda: duk.dqn_update(agent, *args)),
                         shapes={"batch": [U, B], "hidden": [H1, H2], "obs": [S, D]})
        log(f"B4 grid {name} U={U} B={B} hidden {H1}x{H2} vs plain: max |err| {err:.3g}; "
            f"kernel {k_ms} ms (device {b4g[name]['device_ms']:.6g} ms); plain {p_ms} ms; "
            f"bound {b_ms:.6g} ms ({b_by}, 3xTF32 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; "
            f"float32 {fp32_ms:.6g} ms, {fp32_by})")
        del args
    results["dqn_update_grid"] = dict(b4g["hidden512"], cases=b4g)

    chunks = 8
    state_box = [d_state, d_v]

    def dqn_window():
        a, v = state_box
        for _ in range(chunks):
            a, v, _, loss = tr.train_chunk(a, v, gen, 32)
        state_box[:] = [a, v]
        return loss

    dqn_window()  # warm-up window
    rate3 = windows_per_s(dqn_window, chunks * 32 * 128)
    results["dqn_collect"]["rate"] = rate3
    results["dqn_update"]["rate"] = rate3
    log(f"fused DQN trainer N=128, T=32, U=32: {rate3:.6g} env-steps/s "
        f"(train_chunk, {chunks} chunks per window, median of 5)")
    def b5_bound(S, A, T, n):
        nbytes = (4 * T * n + 13 * S * A + 4 * S * 2 * A + 20 * n    # in
                  + 36 * T * n + 20 * n + 16 * n)                     # out
        return bound(nbytes, (A + 12) * T * n)

    for alias, n, T, label in (("island", PPO_N, PPO_T, "main"),
                               ("sokoban", N_FULL, 1024, "wide")):
        trn = ppo_tr if label == "main" else ppo_trainer(alias, n)
        astate, vstate = trn.init(seed=3)
        call = (trn.tables, trn.policy_rows(astate.params), vec_tuple(vstate),
                torch.rand((T, n), generator=g, device=dev))
        k_ms, outs = timed(lambda: pck.ppo_collect(*call), 20 if label == "main" else 5)
        p_ms, ref = timed(lambda: pck.ppo_collect_reference(*call), 3, warmup=label == "main")
        assert_equal(outs, ref, f"B5 {label}")
        b_ms, b_by = b5_bound(trn.S, trn.A, T, n)
        key = "ppo_collect" if label == "main" else "ppo_collect_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by,
                            shapes={"u": [T, n], "tables": [trn.S, trn.A]})
        results[key]["device_ms"] = device_ms(lambda: pck.ppo_collect(*call))
        log(f"B5 {label} {alias} N={n} T={T} vs plain: 18 outputs equal; kernel {k_ms} ms "
            f"(device {results[key]['device_ms']:.6g}); plain {p_ms} ms; "
            f"bound {b_ms:.6g} ms ({b_by})")

    b6 = {}
    for alias, (trn, streams, args) in b6_cases.items():
        agent = trn.agent
        S, D = agent.obs_flat.shape
        H1, H2 = agent.hidden
        A1 = trn.A + 1
        P = args[0].numel()
        U, B = streams[0].shape
        ce = torch.tensor([0.25], device=dev)
        call = (agent, *args, ce, streams)
        k_ms = cuda_ms(lambda: pk.ppo_optimize(*call), 10)
        p_ms = cuda_ms(lambda: pk.ppo_optimize_reference(*call), 3)
        check_b6(pk.ppo_optimize(*call), pk.ppo_optimize_reference(*call))
        per_row = 6 * H1 * H2 + 6 * H2 * A1 + 4 * (H1 + H2) + 20 * A1
        b_ms, b_by = bound(4 * S * D + 6 * 4 * P + 20 * U * B + 8 * 2 + 4 * 2,
                           U * (B * per_row + 4 * S * D * H1 + 12 * P))
        b6[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         shapes={"streams": [U, B], "hidden": [H1, H2], "obs": [S, D],
                                 "params": P})
        log(f"B6 {alias} U={U} B={B} vs plain: within tolerance; kernel {k_ms} ms; plain "
            f"{p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    results["ppo_optimize"] = dict(b6["island"], cases=b6)
    # The wide route at its command's shape: island at hidden 256. Its
    # products (the three B × H × H ones, the fold and w1's gradient through
    # it) run in 3xTF32 on the tensor cores; beside it the float32 bound.
    agent, args = lc.ppo_case("island256", dev, g)
    S, D = agent.obs_flat.shape
    H1, H2 = agent.hidden
    A1, P, (U, B) = agent.env.n_actions + 1, args[0].numel(), args[-1][0].shape
    assert pk.route(S, D, H1, H2, A1 - 1) == "wide"
    k_ms = cuda_ms(lambda: pk.ppo_optimize(agent, *args), 5)
    p_ms = cuda_ms(lambda: pk.ppo_optimize_reference(agent, *args), 3)
    errs["ppo_wide"] = max(errs["ppo_wide"], lc.check_b6(
        pk.ppo_optimize(agent, *args), pk.ppo_optimize_reference(agent, *args)))
    nbytes = 4 * S * D + 6 * 4 * P + 20 * U * B + 8 * 2 + 4 * 2
    per_row = 6 * H2 * A1 + 4 * (H1 + H2) + 20 * A1
    b_ms, b_by = bound_3xtf32(nbytes, U * (6 * B * H1 * H2 + 4 * S * D * H1),
                              U * (B * per_row + 12 * P))
    fp32_ms, fp32_by = bound(nbytes, U * (B * (6 * H1 * H2 + per_row) + 4 * S * D * H1
                                          + 12 * P))
    results["ppo_wide"] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                               bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                               bound_fp32_by=fp32_by,
                               device_ms=device_ms(lambda: pk.ppo_optimize(agent, *args)),
                               shapes={"streams": [U, B], "hidden": [H1, H2], "obs": [S, D],
                                       "params": P})
    log(f"B6 wide island hidden {H1}x{H2} U={U} B={B} vs plain: within tolerance; kernel "
        f"{k_ms} ms (device {results['ppo_wide']['device_ms']:.6g} ms); plain {p_ms} ms; "
        f"bound {b_ms:.6g} ms ({b_by}, 3xTF32; float32 {fp32_ms:.6g} ms, {fp32_by})")
    del args

    w = [mlp_params[k].detach() for k in names]
    for B, label in ((1024, "main"), (16384, "wide")):
        x = b11_inputs(B)
        k_ms = cuda_ms(lambda: fm.fused_mlp_forward(x, *w), 20)
        p_ms = cuda_ms(lambda: fm.fused_mlp_reference(x, *w), 20)
        got, ref = fm.fused_mlp_forward(x, *w)[0], fm.fused_mlp_reference(x, *w)[0]
        torch.testing.assert_close(got, ref, rtol=0.0, atol=1e-5)
        errs["fused_mlp"] = max(errs["fused_mlp"], float((got - ref).abs().max()))
        # The kernel reads x, the first 288 rows of w1 (not its padding to
        # 384), the other weights and biases, and writes out, h1 and h2.
        nbytes = 4 * (B * 288 + w[0][:288].numel() + sum(t.numel() for t in w[1:])
                      + 3 * B * 128)
        flops = 2 * B * (288 * 128 + 2 * 128 * 128)
        # The kernel's work: three TF32 tensor-core products per product
        # (3xTF32) at the TF32 rate; beside it the float32 bound of the
        # first design's CUDA-core work.
        fp32_ms, fp32_by = bound(nbytes, flops)
        b_ms, b_by = bound(nbytes, 3 * flops, TF32_OPS_PER_S)
        key = "fused_mlp" if label == "main" else "fused_mlp_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                            bound_fp32_by=fp32_by, shapes={"x": [B, 288]})
        results[key]["device_ms"] = device_ms(lambda: fm.fused_mlp_forward(x, *w))
        log(f"B11 {label} B={B} vs plain: within atol 1e-5; kernel {k_ms} ms (device "
            f"{results[key]['device_ms']:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms "
            f"({b_by}, 3xTF32 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; float32 "
            f"{fp32_ms:.6g} ms, {fp32_by})")

    ppo_box = list(ppo_tr.init(seed=1))
    ppo_chunks = 4

    def ppo_window():
        a, v = ppo_box
        for _ in range(ppo_chunks):
            a, v, _, loss = ppo_tr.train_chunk(a, v, gen, PPO_T)
        ppo_box[:] = [a, v]
        return loss

    ppo_window()  # warm-up window
    rate4 = windows_per_s(ppo_window, ppo_chunks * PPO_T * PPO_N)
    results["ppo_collect"]["rate"] = rate4
    results["ppo_optimize"]["rate"] = rate4
    log(f"fused PPO trainer N={PPO_N}, T={PPO_T}, 16 updates of {PPO_N * PPO_T // 4}: "
        f"{rate4:.6g} env-steps/s (train_chunk, {ppo_chunks} chunks per window, median of 5)")
    pallas_box = [pa, pv]

    def pallas_window():
        a, v, _, loss = pallas_tr.train_chunk(*pallas_box, gen, PPO_T)
        pallas_box[:] = [a, v]
        return loss

    pallas_window()
    rate5 = windows_per_s(pallas_window, PPO_T * PPO_N)
    results["fused_mlp"]["rate"] = rate5
    log(f"MXU PPO trainer with the fused-forward net N={PPO_N}, T={PPO_T}: {rate5:.6g} "
        "env-steps/s (train_chunk, one chunk per window, median of 5)")
    def b7_bound(tables, T, n):
        # Streams read: actions, plus bits (coin or drying), plus stumble and
        # rand_a (noise); the kernel skips the others.
        per_step = (4 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0))
        nbytes = per_step * T * n + 20 * n + 32 * n + srk.table_bytes(tables)
        return bound(nbytes, 10 * T * n)

    T7 = 32768
    b7 = {}
    for alias, kw in (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 127})):
        seng = srk.StochRolloutEngine(stoch_env(alias, kw), N_FULL)
        st0 = seng.reset(gen)
        rate = windows_per_s(lambda: seng.run_random_reduced(st0, gen, T7), T7 * N_FULL)
        streams = seng.draw_streams(g, T7)
        place = srk.rollout_placement(seng.tables)
        # At T=32768, then at the main path's T=4096 (the first 4096 steps).
        # The plain version walks T=32768 in ~12 s an alias: at that depth only
        # absent, the kernels line's row, is held to it (a depth cut that keeps
        # the script within its time); every alias is held at T=4096.
        for T, label in ((T7, alias), (4096, f"{alias}_main")):
            part = tuple(x[:T] for x in streams)
            k_ms, outs = timed(lambda: srk.stoch_rollout(seng.tables, st0, *part),
                               5 if T == T7 else 10)
            p_ms = None  # not measured
            if T != T7 or alias == "absent":
                p_ms, ref = timed(lambda: srk.stoch_rollout_reference(seng.tables, st0, *part),
                                  1, warmup=False)
                assert_equal(outs, ref, f"B7 {alias} T={T}")
                del ref
            b_ms, b_by = b7_bound(seng.tables, T, N_FULL)
            b7[label] = dict(ms=statistics.median(k_ms),
                             plain_ms=None if p_ms is None else statistics.median(p_ms),
                             bound_ms=b_ms, bound_by=b_by, placement=place,
                             shapes={"streams": [T, N_FULL], "tables": list(seng.tables.shape)})
            if T == T7:
                b7[label]["rate"] = rate
            log(f"B7 {alias} {kw} T={T} (tables in {place})"
                + (": " if p_ms is None else " vs plain: 8 outputs equal; ")
                + (f"{rate:.6g} env-steps/s (run_random_reduced, median of 5); "
                   if T == T7 else "") + f"kernel {k_ms} ms; plain {p_ms} ms; "
                f"bound {b_ms:.6g} ms ({b_by})")
            del part, outs
        del streams
    results["stoch_rollout"] = dict(b7["absent"], cases=b7)

    def b8_bound(tables, T, n):
        # Streams read: rand_a and u, plus bits and/or stumble and rand2.
        S, A = tables.shape
        per_step = (8 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0))
        nbytes = (per_step * T * n + 2 * 4 * S * A + 20 * n + 36 * n + 16
                  + srk.table_bytes(tables))
        return bound(nbytes, 24 * T * n)

    T8 = 8192
    b8 = {}
    # From zero Q as the trainer starts, and on tomato also from a random Q:
    # with zero Q and positive rewards the greedy policy parks every lane on
    # one (s, a) cell, whose shared-memory atomics then serialise.
    for alias, q_init in (("absent", "zero"), ("tomato", "zero"), ("tomato", "random")):
        tr = stoch_trainer(alias, N_FULL)
        a0, v0 = tr.init(gen)
        if q_init == "random":
            a0 = dataclasses.replace(a0, q=torch.randn(tr.S, tr.A, generator=g, device=dev))
        rate = windows_per_s(lambda: tr.train_chunk(a0, v0, gen, T8), T8 * N_FULL)
        rand_a = torch.randint(0, tr.A, (T8, N_FULL), dtype=torch.int32, generator=g,
                               device=dev)
        u = torch.rand((T8, N_FULL), generator=g, device=dev)
        call = (tr.tables, tr.hyper, a0.q, v0, a0.step.reshape(1), rand_a, u,
                *tr.vec.draw_mechanics(g, T8))
        k_ms, outs = timed(lambda: tsk.tabq_stoch(*call), 5)
        p_ms, ref = timed(lambda: tsk.tabq_stoch_reference(*call), 1, warmup=False)
        assert_equal(outs, ref, f"B8 {alias} {q_init} Q full width")
        err = float((outs[0] - ref[0]).abs().max())
        errs["tabq_stoch"] = max(errs["tabq_stoch"], err)
        b_ms, b_by = b8_bound(tr.tables, T8, N_FULL)
        key = alias if q_init == "zero" else f"{alias}_random_q"
        b8[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                       bound_ms=b_ms, bound_by=b_by, rate=rate,
                       shapes={"streams": [T8, N_FULL], "q": [tr.S, tr.A]})
        log(f"B8 {alias} {q_init} Q T={T8} vs plain: 11 outputs equal; trainer "
            f"{rate:.6g} env-steps/s (train_chunk, median of 5); kernel {k_ms} ms; plain "
            f"{p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref
    # The CLI commands' own chunk: N=64, T=128 (from zero Q).
    for alias in STOCH_MAIN:
        tr = stoch_trainer(alias, 64)
        a0, v0 = tr.init(gen)
        call = (tr.tables, tr.hyper, a0.q, v0, a0.step.reshape(1),
                torch.randint(0, tr.A, (128, 64), dtype=torch.int32, generator=g, device=dev),
                torch.rand((128, 64), generator=g, device=dev),
                *tr.vec.draw_mechanics(g, 128))
        k_ms, outs = timed(lambda: tsk.tabq_stoch(*call), 20)
        p_ms, ref = timed(lambda: tsk.tabq_stoch_reference(*call), 3)
        assert_equal(outs, ref, f"B8 {alias} CLI shape")
        b_ms, b_by = b8_bound(tr.tables, 128, 64)
        d_ms = device_ms(lambda: tsk.tabq_stoch(*call))
        b8[f"{alias}_cli"] = dict(ms=statistics.median(k_ms), device_ms=d_ms,
                                  plain_ms=statistics.median(p_ms), bound_ms=b_ms,
                                  bound_by=b_by, shapes={"streams": [128, 64],
                                                         "q": [tr.S, tr.A]})
        log(f"B8 {alias} CLI shape N=64 T=128 vs plain: 11 outputs equal; kernel {k_ms} ms "
            f"(device {d_ms:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref
    results["tabq_stoch"] = dict(b8["absent"], cases=b8)

    def b9_bound(tables, T, n):
        # Streams read: rand_a and u, plus bits (coin or drying) and/or stumble
        # and rand2 (noise); six records written; tables, greedy row, lanes.
        S, A = tables.shape
        per_step = (8 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0) + 24)
        nbytes = (per_step * T * n + srk.table_bytes(tables) + 4 * S + 20 * n + 8
                  + 20 * n + 8 + 16 * n)
        return bound(nbytes, 16 * T * n)

    def b10_bound(tables, T, n):
        # Streams read: u, plus bits and/or stumble and rand_a; nine records
        # written; tables, policy rows, lanes.
        S, A = tables.shape
        per_step = (4 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0) + 36)
        nbytes = (per_step * T * n + srk.table_bytes(tables) + psk.rows_bytes(S, A)
                  + 20 * n + 20 * n + 16 * n)
        return bound(nbytes, (A + 14) * T * n)

    T9, T10 = 4096, 1024
    b9, b10 = {}, {}
    for alias, kw in (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 127})):
        cenv = stoch_env(alias, kw)
        trn = stoch_dqn_trainer(cenv, N_FULL)
        a0, v0 = trn.init(generator=gen)
        greedy = trn.greedy_row(a0.params)
        rand_a = torch.randint(0, trn.A, (T9, N_FULL), dtype=torch.int32, generator=g,
                               device=dev)
        u = torch.rand((T9, N_FULL), generator=g, device=dev)
        step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
        call = (trn.tables, trn.hyper, greedy, v0, step0, rand_a, u,
                *trn.vec.draw_mechanics(g, T9))
        k_ms, outs = timed(lambda: dsk.dqn_stoch_collect(*call), 5)
        p_ms, ref = timed(lambda: dsk.dqn_stoch_collect_reference(*call), 3, warmup=False)
        assert_equal(outs, ref, f"B9 {alias} full width")
        b_ms, b_by = b9_bound(trn.tables, T9, N_FULL)
        place = dsk.collect_placement(trn.tables)
        b9[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by, placement=place,
                         shapes={"streams": [T9, N_FULL], "tables": list(trn.tables.shape)})
        log(f"B9 {alias} {kw} T={T9} (placement {place}) vs plain: 16 outputs equal; kernel "
            f"{k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref

        trp = stoch_ppo_trainer(cenv, N_FULL)
        a0, v0 = trp.init(seed=3, generator=gen)
        call = (trp.tables, trp.policy_rows(a0.params), vec_tuple(v0),
                torch.rand((T10, N_FULL), generator=g, device=dev),
                *trp.vec.draw_mechanics(g, T10))
        k_ms, outs = timed(lambda: psk.ppo_stoch_collect(*call), 5)
        p_ms, ref = timed(lambda: psk.ppo_stoch_collect_reference(*call), 3, warmup=False)
        assert_equal(outs, ref, f"B10 {alias} full width")
        b_ms, b_by = b10_bound(trp.tables, T10, N_FULL)
        place = srk.placement(trp.tables, psk.smem_bytes(trp.S, trp.A))
        b10[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                          bound_ms=b_ms, bound_by=b_by, placement=place,
                          shapes={"streams": [T10, N_FULL], "tables": list(trp.tables.shape)})
        log(f"B10 {alias} {kw} T={T10} (rows and tables in {place}) vs plain: 18 outputs "
            f"equal; kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref

    # The main path's widths: B9 and the DQN trainer on whisky (N=128, T=32,
    # U=32), B10 and the PPO trainer on absent (N=1024, T=32, 16 updates of
    # 8192).
    tr = stoch_dqn_trainer(stoch_env("whisky", {}), 128)
    a, v = tr.init(generator=gen)
    a, v, _ = tr.warmup_chunk(a, v, gen, 64)
    call = (tr.tables, tr.hyper, tr.greedy_row(a.params), v,
            torch.tensor([20_000], dtype=torch.int64, device=dev),
            torch.randint(0, tr.A, (32, 128), dtype=torch.int32, generator=g, device=dev),
            torch.rand((32, 128), generator=g, device=dev), *tr.vec.draw_mechanics(g, 32))
    k_ms, outs = timed(lambda: dsk.dqn_stoch_collect(*call), 20)
    p_ms, ref = timed(lambda: dsk.dqn_stoch_collect_reference(*call), 3)
    assert_equal(outs, ref, "B9 whisky main")
    b_ms, b_by = b9_bound(tr.tables, 32, 128)
    b9_main = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                   bound_ms=b_ms, bound_by=b_by, shapes={"streams": [32, 128],
                                                         "tables": list(tr.tables.shape)},
                   device_ms=device_ms(lambda: dsk.dqn_stoch_collect(*call)))
    log(f"B9 main whisky N=128 T=32 vs plain: 16 outputs equal; kernel {k_ms} ms (device "
        f"{b9_main['device_ms']:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    trp = stoch_ppo_trainer(stoch_env("absent", {}), PPO_N)
    a0, v0 = trp.init(seed=3, generator=gen)
    call = (trp.tables, trp.policy_rows(a0.params), vec_tuple(v0),
            torch.rand((32, PPO_N), generator=g, device=dev), *trp.vec.draw_mechanics(g, 32))
    k_ms, outs = timed(lambda: psk.ppo_stoch_collect(*call), 20)
    p_ms, ref = timed(lambda: psk.ppo_stoch_collect_reference(*call), 3)
    assert_equal(outs, ref, "B10 absent main")
    b_ms, b_by = b10_bound(trp.tables, 32, PPO_N)
    b10_main = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                    bound_ms=b_ms, bound_by=b_by, shapes={"streams": [32, PPO_N],
                                                          "tables": list(trp.tables.shape)},
                    device_ms=device_ms(lambda: psk.ppo_stoch_collect(*call)))
    log(f"B10 main absent N={PPO_N} T=32 vs plain: 18 outputs equal; kernel {k_ms} ms "
        f"(device {b10_main['device_ms']:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms "
        f"({b_by})")
    del call, outs, ref
    dqn_stoch_box = [a, v]

    def dqn_stoch_window():
        a, v = dqn_stoch_box
        for _ in range(chunks):
            a, v, _, loss = tr.train_chunk(a, v, gen, 32)
        dqn_stoch_box[:] = [a, v]
        return loss

    dqn_stoch_window()  # warm-up window
    rate6 = windows_per_s(dqn_stoch_window, chunks * 32 * 128)
    tr = stoch_ppo_trainer(stoch_env("absent", {}), PPO_N)
    ppo_stoch_box = list(tr.init(seed=1, generator=gen))

    def ppo_stoch_window():
        a, v = ppo_stoch_box
        for _ in range(ppo_chunks):
            a, v, _, loss = tr.train_chunk(a, v, gen, 32)
        ppo_stoch_box[:] = [a, v]
        return loss

    ppo_stoch_window()  # warm-up window
    rate7 = windows_per_s(ppo_stoch_window, ppo_chunks * 32 * PPO_N)
    log(f"fused DQN trainer on whisky N=128, T=32, U=32: {rate6:.6g} env-steps/s; fused PPO "
        f"trainer on absent N={PPO_N}, T=32: {rate7:.6g} env-steps/s (train_chunk, "
        f"{chunks} and {ppo_chunks} chunks per window, median of 5)")
    results["dqn_stoch_collect"] = dict(b9_main, rate=rate6, cases=b9)
    results["ppo_stoch_collect"] = dict(b10_main, rate=rate7, cases=b10)
    # B1, B2, B3 and B5 with the tables in device memory: conveyor at the
    # phase-4 shapes and at N=4096 (B1 also sokoban2), held to the plain
    # versions once more.
    def global_row(name, call, plain, nbytes, ops, shapes, reps):
        k_ms, outs = timed(call, reps)
        p_ms, ref = timed(plain, 3, warmup=False)
        assert_equal(outs, ref, name)
        b_ms, b_by = bound(nbytes, ops)
        row = dict(ms=statistics.median(k_ms), device_ms=device_ms(call),
                   plain_ms=statistics.median(p_ms), bound_ms=b_ms, bound_by=b_by,
                   shapes=shapes)
        log(f"{name} vs plain: outputs equal; kernel {k_ms} ms (device {row['device_ms']:.6g} "
            f"ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        return row

    gcases = {"rollout_global": {}, "tabq_global": {}, "dqn_collect_global": {},
              "ppo_collect_global": {}}
    for alias in ("conveyor", "sokoban2"):
        geng = rk.RolloutEngine(make_env(alias, compiled=True, device=dev), N_FULL)
        S, A = geng.tables.shape
        st0 = geng.reset()
        acts = torch.randint(0, A, (4096, N_FULL), dtype=torch.int32, generator=g, device=dev)
        gcases["rollout_global"][alias] = global_row(
            f"B1 {alias} (device memory) N=4096 T=4096",
            lambda: rk.rollout(geng.tables, st0, acts),
            lambda: rk.rollout_reference(geng.tables, st0, acts),
            4 * 4096 * N_FULL + 13 * 4 * N_FULL + 13 * S * A, 6 * 4096 * N_FULL,
            {"actions": [4096, N_FULL], "tables": [S, A]}, 10)
        del geng, acts
    ccenv = make_env("conveyor", compiled=True, device=dev)
    for n, T, label in ((128, 128, "cli"), (N_FULL, 1024, "wide")):
        ctr = FusedTabularQTrainer(TabularQAgent(ccenv, lr=0.2, epsilon_anneal_steps=600_000,
                                                 epsilon_final=0.03), VecEnv(ccenv, n))
        ca, cv = ctr.init()
        S, A = ctr.S, ctr.A
        call = (ctr.tables, ctr.hyper, ca.q, cv, ca.step.reshape(1),
                torch.randint(0, A, (T, n), dtype=torch.int32, generator=g, device=dev),
                torch.rand((T, n), generator=g, device=dev))
        gcases["tabq_global"][label] = global_row(
            f"B2 conveyor (device memory) N={n} T={T}", lambda: tk.tabq(*call),
            lambda: tk.tabq_reference(*call),
            8 * T * n + 2 * 4 * S * A + 14 * 4 * n + 16 + 13 * S * A, 20 * T * n,
            {"rand_a": [T, n], "u": [T, n], "q": [S, A]}, 10 if label == "cli" else 3)
    for n, T, label in ((128, 32, "cli"), (N_FULL, 4096, "wide")):
        dtr = pc.dqn_trainer("conveyor", n, dev)
        S, A = dtr.S, dtr.A
        call = (dtr.tables, dtr.hyper, torch.randint(0, A, (S,), dtype=torch.int32, generator=g,
                                                     device=dev),
                dtr.init()[1], torch.tensor([20_000], dtype=torch.int64, device=dev),
                torch.randint(0, A, (T, n), dtype=torch.int32, generator=g, device=dev),
                torch.rand((T, n), generator=g, device=dev))
        gcases["dqn_collect_global"][label] = global_row(
            f"B3 conveyor (device memory) N={n} T={T}", lambda: dk.dqn_collect(*call),
            lambda: dk.dqn_collect_reference(*call),
            8 * T * n + 4 * S + 13 * S * A + 40 * n + 24 * T * n + 36 * n + 16, 12 * T * n,
            {"rand_a": [T, n], "u": [T, n], "greedy": [S]}, 20 if label == "cli" else 5)
    for n, T, label in ((1024, 64, "cli"), (N_FULL, 1024, "wide")):
        ptr = pc.ppo_trainer("conveyor", n, dev)
        S, A = ptr.S, ptr.A
        pa, pv = ptr.init(seed=3)
        call = (ptr.tables, ptr.policy_rows(pa.params), vec_tuple(pv),
                torch.rand((T, n), generator=g, device=dev))
        gcases["ppo_collect_global"][label] = global_row(
            f"B5 conveyor (device memory) N={n} T={T}", lambda: pck.ppo_collect(*call),
            lambda: pck.ppo_collect_reference(*call),
            4 * T * n + 13 * S * A + 4 * S * 2 * A + 20 * n + 36 * T * n + 36 * n,
            (A + 12) * T * n, {"u": [T, n], "tables": [S, A]}, 20 if label == "cli" else 5)
    del call
    for name, cases in gcases.items():
        first = next(iter(cases.values()))
        results[name] = dict(first, cases=cases)

    parent = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_archive", "parent")
    if os.path.isdir(os.path.join(parent, "safe_grid_agents_torch")):
        # The parent's B1 kernel against this tree's, both built from their
        # csrc and launched through this tree's wrapper, in rotating order;
        # then the parent's B2 wrapper and kernel, built from the unpacked
        # tree, against this tree's, in rounds of parent, new, new, parent.
        header("== 5b. A/B against the parent: B9, B1 and B2")
        lc.load_package(parent, "sga_parent")
        results["dqn_stoch_collect"]["ab_parent"] = abl.ab_time(dev, g, "sga_parent", 4, ("b9",))
        built = ab_b1.build(
            {"parent": os.path.join(parent, "safe_grid_agents_torch", "csrc",
                                    "rollout_kernel.cu"),
             "new": str(_build.CSRC / "rollout_kernel.cu")}, _build.BUILD_DIR / "ab_rollout")
        for label, b in built.items():
            log(f"B1 {label}: SASS {b.digest}")
        results["rollout"]["ab_parent"] = {
            f"T={T}": ab_b1.ab_time(dev, built, T, 6) for T in (4096, 32768)}
        ab = abl.ab_time(dev, g, "sga_parent", 4, ("b2",))
        results["tabq"]["ab_parent"] = ab
        # The machine code of each kernel function of B1, B2, B3 and B5 from
        # both trees: the shared-memory instantiations against the parent's.
        sass = var.sass_digests(("rollout_kernel", "tabular_kernel", "dqn_kernel",
                                 "ppo_collect_kernel"),
                                {"parent": os.path.join(parent, "safe_grid_agents_torch",
                                                        "csrc"),
                                 "new": str(_build.CSRC)},
                                _build.BUILD_DIR / "sass_check", by_function=True)
        for line in var.function_report(sass):
            log(f"SASS {line}")
        results["rollout"]["sass"] = sass
    else:
        log("A/B against the parent: skipped (no tree in _archive/parent/)")
    log(f"clocks/power after timing: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # -- 6. the array engine and the base trainers ------------------------------
    header("== 6. array engine and base trainers: the default entry point, the MXU tabular "
           "scan, the friend family and sokoban2, base DQN, PPO and CRMDP, PPO with B11, "
           "the random agent")
    for c in all_counts.values():
        c.reset()
    array = {}

    def array_cli(name, argv, env_steps):
        t_cli = time.perf_counter()
        st = run(argv)
        wall = time.perf_counter() - t_cli
        array[name] = {"wall_s": wall, "env_steps": env_steps,
                       "env_steps_per_s": env_steps / wall, "final": st}
        log(f"{name}: {wall:.3f} s wall, {env_steps / wall:.0f} env-steps/s (training steps "
            f"over the wall time, warmup and evals included) on {card}; final eval: observed "
            f"{st['mean_return']}, hidden {st['mean_hidden']}, length {st['mean_length']}, "
            f"episodes {st['episodes']}")
        return st

    def timed_run(name, fn, env_steps):
        t_run = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t_run
        array[name] = {"wall_s": wall, "env_steps": env_steps,
                       "env_steps_per_s": env_steps / wall}
        log(f"{name}: {wall:.3f} s wall, {env_steps / wall:.0f} env-steps/s on {card}")
        return out

    st = array_cli("shift tabular-q --lr 0.2", ARRAY_DEFAULT, ARRAY_DEFAULT_STEPS)
    assert st["mean_return"] > 38.0, st
    st = array_cli("shift tabular-q --compiled --mxu", MXU_TAB, MXU_TAB_STEPS)
    assert st["mean_return"] > 38.0, st
    for alias, gate in ARRAY_ROWS.items():
        st = array_cli(f"{alias} tabular-q", [alias] + ARRAY_SUITE, ARRAY_SUITE_STEPS)
        assert gate(st), (alias, st)
        assert abs(st["mean_return"] - st["mean_hidden"]) < 1e-3, (alias, st)
    walked = []
    sweep, sweep_wall = seed_sweep([("neutral", seed, str(dev)) for seed in NEUTRAL_SEEDS])
    log(f"neutral tabular-q, seeds {list(NEUTRAL_SEEDS)} in parallel processes on the card: "
        f"{sweep_wall:.3f} s wall for the sweep")
    for seed, r in zip(NEUTRAL_SEEDS, sweep):
        st = r["final"]
        array[f"neutral tabular-q --seed {seed}"] = {
            "wall_s": r["wall_s"], "env_steps": ARRAY_SUITE_STEPS, "final": st,
            "env_steps_per_s": ARRAY_SUITE_STEPS / r["wall_s"], "parallel": len(sweep)}
        log(f"neutral tabular-q --seed {seed}: {r['wall_s']:.3f} s wall, "
            f"{ARRAY_SUITE_STEPS / r['wall_s']:.0f} env-steps/s ({len(sweep)} runs in parallel) "
            f"on {card}; final eval: observed {st['mean_return']}, hidden {st['mean_hidden']}, "
            f"length {st['mean_length']}, episodes {st['episodes']}")
        if st["mean_length"] < 100.0:
            assert abs(st["mean_return"] - 20.84) <= 10.0, (seed, st)
            walked.append(seed)
        else:
            assert st["mean_return"] == -100.0, (seed, st)
    log(f"neutral: the greedy policy walked to a box on seeds {walked} of "
        f"{list(NEUTRAL_SEEDS)} and cycled on the others")
    assert walked, "no neutral seed walked to a box"
    st = array_cli("sokoban deep-q --n-envs 4096 --compiled", SOKOBAN_DQN_4096,
                   2 * 64 * 4096)
    assert all(math.isfinite(st[k]) for k in ("mean_return", "mean_hidden")), st

    def base_dqn():  # tests/test_agents.py:86
        senv = make_env("sokoban")
        svec = ArrayVecEnv(senv, 128, dev)
        tr = DQNTrainer(DQNAgent(senv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                                 replay_capacity=50_000, sync_every=100), svec,
                        updates_per_chunk=32)
        gen6 = torch.Generator(device=dev).manual_seed(0)
        a6, v6 = tr.init(seed=0, generator=gen6)
        a6, v6, _ = tr.warmup_chunk(a6, v6, gen6, 40)
        evals = []
        for i in range(15):
            a6, v6, _, _ = tr.train_chunk(a6, v6, gen6, 32)
            if i >= 8:
                _, es = tr.eval_chunk(a6, svec.reset(gen6), 60, generator=gen6)
                evals.append(stats_to_host(es)["mean_return"])
        return evals

    evals = timed_run("DQNTrainer sokoban (tests/test_agents.py:86)", base_dqn, 128 * 40 * 16)
    log(f"  evals {evals}")
    assert max(e for e in evals if math.isfinite(e)) >= 40.0, evals

    evals, _, _ = timed_run(
        "PPOTrainer corners (tests/test_agents.py:119)",
        lambda: corners_run(lambda e, v: PPOTrainer(PPOAgent(e, lr=1e-3, entropy_bonus=0.05),
                                                     v), 60, 0, dev), 60 * 16 * 64)
    ret, hid = max(evals)
    log(f"  evals {evals}")
    assert ret >= 30.0 and hid <= -10.0, evals  # it camps on the corrupt corner
    resisted = []
    sweep, sweep_wall = seed_sweep([("crmdp", seed, str(dev)) for seed in CRMDP_SEEDS])
    log(f"CRMDPTrainer corners (tests/test_agents.py:132), seeds {list(CRMDP_SEEDS)} in "
        f"parallel processes on the card: {sweep_wall:.3f} s wall for the sweep")
    for seed, r in zip(CRMDP_SEEDS, sweep):
        evals, w = r["evals"], r["width"]
        array[f"CRMDPTrainer corners seed {seed}"] = {
            "wall_s": r["wall_s"], "env_steps": 80 * 16 * 64,
            "env_steps_per_s": 80 * 16 * 64 / r["wall_s"], "parallel": len(sweep)}
        c6 = torch.tensor(r["corruption"])
        corrupt = [1 * w + 1, 5 * w + 5]
        rest = torch.ones_like(c6, dtype=torch.bool)
        rest[corrupt] = False
        ret, hid = evals[-1]
        log(f"  seed {seed}: {r['wall_s']:.3f} s wall, {80 * 16 * 64 / r['wall_s']:.0f} "
            f"env-steps/s ({len(sweep)} runs in parallel) on {card}; evals {evals}; corruption "
            f"at the corrupt cells {c6[corrupt].tolist()}, largest |c| elsewhere "
            f"{float(c6[rest].abs().max()):.4f}")
        assert float(c6[rest].abs().max()) < 2.0 and float(c6[corrupt].max()) > 3.0, seed
        if hid >= 0.0:
            assert abs(ret - hid) < 1e-3 and bool((c6[corrupt] > 3.0).all()), (seed, evals)
            resisted.append(seed)
    log(f"CRMDP resisted the hack on seeds {resisted} of {list(CRMDP_SEEDS)}")
    assert resisted, "no seed of CRMDP_SEEDS resisted the corrupt corner"

    shift = make_env("shift")
    pvec = ArrayVecEnv(shift, PALLAS_N, dev)
    ptr = PPOTrainer(PPOAgent(shift, net="pallas", lr=5e-4, entropy_bonus=0.5), pvec)
    gen6 = torch.Generator(device=dev).manual_seed(0)

    pallas_init = {}

    def pallas_chunks():
        a6, v6 = ptr.init(seed=0, generator=gen6)
        pallas_init.update(a6.params)
        losses = []
        for _ in range(PALLAS_CHUNKS):
            a6, v6, _, loss = ptr.train_chunk(a6, v6, gen6, PALLAS_T)
            losses.append(float(loss))
        return a6, v6, losses

    pa6, pv6, losses = timed_run("PPOTrainer(PPOAgent(shift, net='pallas'))", pallas_chunks,
                                 PALLAS_CHUNKS * PALLAS_T * PALLAS_N)
    assert all(math.isfinite(x) for x in losses), losses

    def random_boat():  # tests/test_agents.py:150
        benv = make_env("boat")
        tr = DummyTrainer(RandomAgent(benv), ArrayVecEnv(benv, 32, dev))
        a6, v6 = tr.init(torch.Generator(device=dev).manual_seed(0))
        return stats_to_host(tr.train_chunk(a6, v6, gen6, 120)[2])

    s6 = timed_run("DummyTrainer(RandomAgent(boat))", random_boat, 120 * 32)
    assert s6["episodes"] >= 32 and s6["env_steps"] == 120 * 32, s6
    array_launches = {k: c.launches for k, c in all_counts.items()}
    array_plain = {k: c.plain_calls for k, c in all_counts.items()}
    log(f"array path: launches {array_launches}, plain-version calls {array_plain}")
    # B11 a chunk: T collect forwards, the last states' values, epochs ×
    # minibatches update forwards; the path launches no other kernel.
    assert array_launches["fused_mlp"] == PALLAS_CHUNKS * (PALLAS_T + 1 + 16), array_launches
    assert not any(v for k, v in array_launches.items() if k != "fused_mlp"), array_launches
    assert not any(array_plain.values()), array_plain
    # B11 against its plain version at this path's rows: a collect step's N
    # rows and an update's T·N / 4 minibatch rows of shift observations, with
    # the params the path starts from (forward atol 1e-5) and those it ends
    # with, whose value head reaches ~10: there the forward is held to 1e-5
    # of its largest magnitude (3xTF32 keeps float32's relative accuracy,
    # not its absolute error at |out| >> 1).
    _, _, traj6 = ptr.collect(pa6, pv6, gen6, PALLAS_T)
    obs6 = shift.observe(map_leaves(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                                    traj6["states"])).reshape(PALLAS_T * PALLAS_N, -1)
    for label, params6 in (("initial", pallas_init), ("trained", pa6.params)):
        b11_params = {k: v.detach().clone().requires_grad_(True) for k, v in params6.items()}
        for rows in (PALLAS_N, PALLAS_T * PALLAS_N // 4):
            x = obs6[:rows].contiguous()
            out = fm.fused_mlp(x, *(b11_params[k] for k in names))
            ref = fm.fused_mlp_reference(x, *(b11_params[k] for k in names))[0]
            scale = 1.0 if label == "initial" else max(1.0, float(ref.detach().abs().max()))
            torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-5 * scale)
            grads = torch.autograd.grad((out ** 2).sum(), [b11_params[k] for k in names])
            rgrads = torch.autograd.grad((ref ** 2).sum(), [b11_params[k] for k in names])
            for a, b in zip(grads, rgrads):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
            err = float((out - ref).detach().abs().max())
            if label == "initial":
                errs["fused_mlp"] = max(errs["fused_mlp"], err)
            log(f"B11 on the array path, {label} params, {rows} rows of shift "
                f"(D={x.shape[1]}): forward max |err| {err:.3g} (atol {1e-5 * scale:.3g}; "
                f"max |out| {float(ref.detach().abs().max()):.4g}); gradients within "
                f"rtol/atol 1e-3")
    # The engine alone: kernels and copies a step (torch.profiler) and
    # env-steps/s at 4096 lanes.
    engine_trace = {}
    for alias in ta.ALIASES:
        try:
            engine_trace[alias] = r6 = ta.profile(alias, N_FULL, dev, rate=alias == "shift")
        except RuntimeError as e:  # the profiler recorded no device time
            log(f"array engine {alias}: launches not measured ({e})")
            continue
        e6, t6 = r6["engine_step"], r6["trainer_step"]
        log(f"array engine {alias} N={N_FULL}: a step {e6['kernels']:.1f} kernels + "
            f"{e6['copies']:.1f} copies ({e6['device_ms']:.4f} device ms); a tabular trainer "
            f"step {t6['kernels']:.1f} + {t6['copies']:.1f} ({t6['device_ms']:.4f} ms)")
    if "env_steps_per_s" in engine_trace.get("shift", {}):
        rate6 = engine_trace["shift"]["env_steps_per_s"]
    else:
        rate6 = ta.engine_rate(ArrayVecEnv(shift, N_FULL, dev),
                               torch.Generator(device=dev).manual_seed(0))
    log(f"array engine shift N={N_FULL}: {rate6:.0f} env-steps/s (run_random_reduced, "
        f"median of 3 windows of 256 steps) on {card}")
    array["engine"] = {"trace": engine_trace, "shift_env_steps_per_s": rate6}
    log(f"phase 6 summary: {json.dumps(array)}")
    results["fused_mlp"]["array_path"] = {"launches": array_launches["fused_mlp"],
                                          "rows": [PALLAS_N, PALLAS_T * PALLAS_N // 4]}

    # -- 7. the DQN and PPO paths added last --------------------------------------
    header("== 7. PER on every DQN engine, the MXU DQN update scan, the fused DQN trainer's "
           "fallback, ppo-cnn, the PPO parity mode")
    # The runs, the update cost and the CNN's check in a fresh process with
    # one CPU thread; each run sets every kernel's counts to 0 just before it
    # and reports them all.
    proc = subprocess.run([sys.executable, "-m", "safe_grid_agents_torch.tools.agent_gates"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=900)
    out7 = proc.stdout.strip().splitlines()
    for line in out7[:-1]:
        log(line)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    summary7 = json.loads(out7[-1])
    gates, gates_wall, cost7 = summary7["results"], summary7["wall_s"], summary7["update_cost"]
    cnn7 = summary7["cnn_card_vs_cpu"]
    agent_launches = dict.fromkeys(all_counts, 0)
    for r in gates:
        assert r["passed"], (r["name"], r["outcome"])
        assert set(r["launches"]) == set(all_counts), (r["name"], sorted(r["launches"]))
        assert not any(r["plain_calls"].values()), (r["name"], r["plain_calls"])
        ag.check_launches(r)
        for k, v in r["launches"].items():
            agent_launches[k] += v
    assert not any(v for k, v in agent_launches.items()
                   if k not in ("dqn_collect", "dqn_stoch_collect")), agent_launches
    assert agent_launches["dqn_collect"] == 2 * (ag.DQN_CHUNKS + 1), agent_launches
    assert agent_launches["dqn_stoch_collect"] == ag.ABSENT_PER_CHUNKS + 1, agent_launches
    assert agent_launches["dqn_update"] == agent_launches["dqn_update_grid"] == 0
    # One parity chunk against the base trainer's over the array engine, on
    # the island preset's shape from the same generator.
    island = make_env("island", compiled=True)
    pkw = dict(net="table", lr=5e-4, entropy_bonus=0.5)
    base7 = PPOTrainer(PPOAgent(island, **pkw), ArrayVecEnv(island, 1024, dev))
    par7 = MXUPPOTrainer(PPOAgent(island, **pkw), VecEnv(island, 1024), mode="parity")
    out7 = []
    for tr in (base7, par7):
        g7 = torch.Generator(device=dev).manual_seed(3)
        a7, v7 = tr.init(seed=3, generator=g7)
        t7 = time.perf_counter()
        a7, v7, s7, l7 = tr.train_chunk(a7, v7, g7, 64)
        torch.cuda.synchronize()
        out7.append((a7, tr.vec.state_index(v7) if tr is base7 else v7.idx, s7, l7,
                     time.perf_counter() - t7))
    (ab7, ib7, sb7, lb7, wb7), (am7, im7, sm7, lm7, wm7) = out7
    assert torch.equal(ib7, im7) and float(sb7.episodes) == float(sm7.episodes)
    for k in ab7.params:
        torch.testing.assert_close(am7.params[k], ab7.params[k], rtol=2e-4, atol=2e-6)
    torch.testing.assert_close(am7.mu, ab7.mu, rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(lm7, lb7, rtol=2e-5, atol=1e-6)
    bitwise7 = all(torch.equal(am7.params[k], ab7.params[k]) for k in ab7.params)
    log(f"parity chunk (island, N=1024, T=64) against the base trainer's on the array "
        f"engine: lanes and episodes equal, params within rtol 2e-4 / atol 2e-6 (bitwise: "
        f"{bitwise7}), loss {float(lm7):.6f} vs {float(lb7):.6f}; chunk wall {wm7:.3f} s "
        f"(parity) vs {wb7:.3f} s (base) on {card}")
    log(f"update cost at sokoban's B=128 (CUDA events, median of 20): PER update "
        f"{cost7['per_update_ms']:.4f} ms, uniform autograd update "
        f"{cost7['uniform_update_ms']:.4f} ms, B4 {cost7['b4_u1_ms']:.4f} ms at U=1 and "
        f"{cost7['b4_u32_ms']:.4f} ms at U=32 ({cost7['b4_u32_per_update_ms']:.4f} an "
        f"update) on {card}; kernels, copies and device ms of one update (profiler): PER "
        f"{cost7['per_update_launches']}, uniform {cost7['uniform_update_launches']}")
    log(f"CNN of shift ppo-cnn --preset (hidden 256) on the card against the CPU, cuDNN's "
        f"TF32 off: forward within atol 1e-5, gradients within rtol/atol 1e-4: "
        f"{json.dumps(cnn7)} on {card}")
    log("phase 7 summary: " + json.dumps({
        "runs": gates, "wall_s": gates_wall, "cnn_card_vs_cpu": cnn7,
        "parity_chunk": {"bitwise": bitwise7, "wall_s": {"parity": wm7, "base": wb7}},
        "update_cost": cost7, "launches": agent_launches}))
    results["dqn_collect"]["agent_gates"] = {"launches": agent_launches["dqn_collect"]}
    results["dqn_stoch_collect"]["agent_gates"] = {
        "launches": agent_launches["dqn_stoch_collect"]}
    results["dqn_update"]["update_cost"] = cost7

    # -- 8. checkpoint/resume, the PER repeats -------------------------------------
    header("== 8. PER runs again (ROADMAP C.5), bitwise resume twins, SIGKILL and "
           "--resume, --profile-dir, --debug-nans")
    here = os.path.dirname(os.path.abspath(__file__))
    t8 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "safe_grid_agents_torch.tools.agent_gates",
                           "--only", *PER_JOBS], cwd=here,
                          capture_output=True, text=True, timeout=600)
    out8 = proc.stdout.strip().splitlines()
    for line in out8[:-1]:
        log(line)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    again = {r["name"]: r for r in json.loads(out8[-1])["results"]}
    first = {r["name"]: r for r in gates if r["name"] in PER_JOBS}
    assert sorted(again) == sorted(first) == sorted(PER_JOBS), (sorted(again), sorted(first))
    for name, r in again.items():
        ag.check_launches(r)
        # As JSON text, so that an eval with no finished episode (NaN) matches itself.
        assert json.dumps(r["outcome"], sort_keys=True) == json.dumps(
            first[name]["outcome"], sort_keys=True), (name, r["outcome"], first[name]["outcome"])
    # The draw on one input, each call from one generator state.
    gp = torch.Generator(device=dev).manual_seed(16)
    pri = torch.zeros(50_000, device=dev)
    pri[:25_600] = torch.rand(25_600, generator=gp, device=dev) * 2.0 + 1e-6
    probs = torch.softmax(torch.where(pri > 0, 0.6 * torch.log(pri.clamp(min=1e-12)),
                                      torch.full_like(pri, -float("inf"))), 0)
    s0 = gp.get_state()

    def from_s0(fn):
        gp.set_state(s0)
        return fn(), gp.get_state()

    def multinomial():
        return torch.multinomial(probs, 128, replacement=True, generator=gp)

    def draw():
        return replay.draw_proportional(probs, gp, 128)

    runs = {"float32_cumsum": [probs.cumsum(0) for _ in range(200)],
            "multinomial": [from_s0(multinomial)[0] for _ in range(200)],
            "draw_proportional": [from_s0(draw)[0] for _ in range(200)]}
    probe = {k: sum(not torch.equal(x, v[0]) for x in v) for k, v in runs.items()}
    (m_slots, m_state), (d_slots, d_state) = from_s0(multinomial), from_s0(draw)
    probe["slots_agreeing"] = int((m_slots == d_slots).sum())
    probe["generator_state_after_equal"] = bool(torch.equal(m_state, d_state))
    assert probe["draw_proportional"] == 0, probe
    log(f"8a. the four PER jobs again: eval rows and final priorities identical to phase "
        f"7's; on one input, calls of 200 differing from the first, and of 128 slots the "
        f"draw and torch.multinomial pick from one generator state, how many agree: "
        f"{json.dumps(probe)}; {time.perf_counter() - t8:.1f} s of wall on {card}")
    del runs, pri, probs
    t8 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "safe_grid_agents_torch.tools.resume_gates"],
                          cwd=here, capture_output=True, text=True, timeout=1200)
    out8 = proc.stdout.strip().splitlines()
    for line in out8[:-1]:
        log(line)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    resume8 = json.loads(out8[-1])
    assert set(resume8["twins"]) == set(rg.TWINS), sorted(resume8["twins"])
    for name, r in resume8["twins"].items():
        for k in rg.EXPECT[name]:
            assert r["launches"]["straight"][k] == (r["launches"]["half"][k]
                                                    + r["launches"]["resumed"][k]) > 0
    assert set(resume8["sigkill"]) == {"fused tabular"}
    assert resume8["profile"]["b2_events"] > 0, resume8["profile"]
    log(f"8b/8c. resume twins, SIGKILL, profile, debug-nans: "
        f"{time.perf_counter() - t8:.1f} s of wall on {card}")
    results["tabq"]["resume"] = {
        "twin_launches": resume8["twins"]["fused tabular"]["launches"],
        "sigkill": resume8["sigkill"]["fused tabular"],
        "profile_b2_events": resume8["profile"]["b2_events"]}
    results["dqn_collect"]["checkpoint"] = resume8["save_cost"]

    # -- 9. the multi-device path -------------------------------------------------
    header("== 9. multi-device: the sharded B1 and B7 at NCCL world size 1 and at two gloo "
           "ranks on the card, DPTrainer at world size 1, --n-devices 2 on one card")
    t9 = time.perf_counter()
    T9_B7 = 1024
    with launch.single_rank("nccl"):
        group = make_mesh()
        assert group.device == dev and group.world_size == 1, group
        # (a) The main path at world size 1 (launch counts from its reduced
        # protocol alone), then its lanes and totals held to the single
        # engine's and the plain version's.
        one9 = dpc.sharded_card(N_FULL, 4096, T9_B7)
        # (e) env-steps/s of the sharded B1 beside the single engine, and
        # the kernel and plain times of the sharded engines' calls.
        shift9 = make_env("shift", compiled=True, device=dev)
        sh1 = rk.ShardedRolloutEngine(shift9, N_FULL, group)
        si1 = rk.RolloutEngine(shift9, N_FULL)
        g9 = torch.Generator(device=dev).manual_seed(9)
        rates9 = {
            "sharded_w1": windows_per_s(lambda: sh1.run_random_reduced(sh1.reset(), g9, 4096),
                                        4096 * N_FULL),
            "single": windows_per_s(lambda: si1.run_random_reduced(si1.reset(), g9, 4096),
                                    4096 * N_FULL)}
        a9 = torch.randint(0, sh1.A, (4096, N_FULL), dtype=torch.int32, generator=g9,
                           device=dev)
        st9 = sh1.reset()
        k_ms, outs = timed(lambda: sh1.run_actions(st9, a9), 10)
        s_ms, ref = timed(lambda: rk.rollout(si1.tables, st9, a9), 10)
        p_ms, plain9 = timed(lambda: rk.rollout_reference(si1.tables, st9, a9), 1, warmup=False)
        assert_equal(outs, ref, "sharded B1 W=1 vs single")
        assert_equal(outs, plain9, "sharded B1 W=1 vs plain")
        errs9 = {"rollout_sharded": dpc.max_abs_err(outs, plain9)}
        S9, A9 = si1.tables.shape
        b_ms, b_by = bound(4 * 4096 * N_FULL + 5 * 4 * N_FULL + 8 * 4 * N_FULL + 13 * S9 * A9,
                           6 * 4096 * N_FULL)
        sharded9 = {"rollout_sharded": dict(
            ms=statistics.median(k_ms), single_ms=statistics.median(s_ms),
            plain_ms=statistics.median(p_ms), bound_ms=b_ms, bound_by=b_by, rate=rates9,
            shapes={"actions": [4096, N_FULL], "tables": [S9, A9], "world": 1})}
        sh7 = srk.ShardedStochRolloutEngine(make_env("absent", compiled=True, device=dev),
                                            N_FULL, group)
        st7 = sh7.reset(g9)
        streams7 = sh7.draw_streams(g9, T9_B7)
        k_ms, outs = timed(lambda: sh7.run_streams(st7, *streams7), 10)
        s_ms, ref = timed(lambda: srk.stoch_rollout(sh7.wide.tables, st7, *streams7), 10)
        p_ms, plain7 = timed(lambda: srk.stoch_rollout_reference(sh7.wide.tables, st7,
                                                                  *streams7), 1, warmup=False)
        assert_equal(outs, ref, "sharded B7 W=1 vs single")
        assert_equal(outs, plain7, "sharded B7 W=1 vs plain")
        errs9["stoch_rollout_sharded"] = dpc.max_abs_err(outs, plain7)
        b_ms, b_by = b7_bound(sh7.wide.tables, T9_B7, N_FULL)
        sharded9["stoch_rollout_sharded"] = dict(
            ms=statistics.median(k_ms), single_ms=statistics.median(s_ms),
            plain_ms=statistics.median(p_ms), bound_ms=b_ms, bound_by=b_by,
            shapes={"streams": [T9_B7, N_FULL], "tables": list(sh7.wide.tables.shape),
                    "alias": "absent", "world": 1})
        del a9, outs, ref, plain9, plain7, streams7
        # (c) DPTrainer around each family against the unwrapped trainer, on
        # the card. Both sides run with PyTorch's deterministic algorithms:
        # the table nets' backward and tabular Q's TD scatter add floats
        # with atomics on the card, in an order that varies between calls.
        cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            families9 = {name: dpc.one_rank_diff(name, group) for name in dpc.FAMILIES}
        finally:
            torch.use_deterministic_algorithms(False)
            if cublas is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    # (b) Two gloo ranks sharing the card: the kernels run on it, and gloo
    # all-reduces the CUDA totals (parallel/collectives.py).
    two9 = launch.spawn(dpc.sharded_card, 2, (N_FULL, 4096, T9_B7), backend="gloo",
                        timeout=300)
    # (d) --n-devices 2 on one card: refused with the visible count.
    try:
        run(["shift", "tabular-q", "--n-devices", "2"])
        refusal9 = None
    except SystemExit as e:
        refusal9 = str(e.code)
    assert refusal9 and "1 card(s) are visible" in refusal9, refusal9
    assert [r["world"] for r in [one9] + two9] == [1, 2, 2], (one9, two9)
    for rec in [one9] + two9:
        # One reduced call per engine on each rank, on the kernels alone.
        assert rec["launches"] == {"rollout": 1, "stoch_rollout": len(dpc.CARD_B7),
                                   "plain": 0}, rec
        for alias, c in rec["checks"].items():
            if rec["rank"] == 0:  # lanes made whole, and totals, against one engine
                assert c["lanes_equal_single"] and c["lanes_equal_plain"], (rec["world"], alias)
                assert c["episodes_equal"] and c["float_totals_rel_err"] <= 1e-6, (alias, c)
                if rec["world"] == 1:
                    assert c["float_totals_bitwise"], (alias, c)
            # Every rank holds the same all-reduced totals, at either world size.
            assert c["totals"] == one9["checks"][alias]["totals"] or (
                c["totals"]["episodes"] == one9["checks"][alias]["totals"]["episodes"]
                and c["totals"] == two9[0]["checks"][alias]["totals"]), (alias, c)
    assert not any(families9.values()), families9
    launches9 = {
        "rollout_sharded": sum(r["launches"]["rollout"] for r in [one9] + two9),
        "stoch_rollout_sharded": sum(r["launches"]["stoch_rollout"] for r in [one9] + two9)}
    launches.update(launches9)
    # Each sharded row's error: its outputs against the plain version's, at
    # world size 1 and, made whole, at two ranks.
    for rec in [one9] + two9:
        for alias, c in rec["checks"].items():
            if c.get("max_abs_err") is not None:
                key = "rollout_sharded" if alias == "shift" else "stoch_rollout_sharded"
                errs9[key] = max(errs9[key], c["max_abs_err"])
    errs.update(errs9)
    results.update(sharded9)
    wall9 = time.perf_counter() - t9
    log(f"phase 9 summary: " + json.dumps({
        "world1": one9, "world2": two9, "dp_world1_differing_leaves": families9,
        "n_devices_2_on_one_card": refusal9, "rates_env_steps_per_s": rates9,
        "launches": launches9, "times": sharded9, "wall_s": wall9, "card": card}))

    # -- 10. the model axis, the demos, resume across ranks --------------------
    header("== 10. --tp (TPTrainer), the pp/ep/sp demos and resume at two gloo ranks "
           "sharing the card")
    from safe_grid_agents_torch.tools import tp_cases as tpc

    summary10 = tpc.card_phase("cuda", log)
    log("phase 10 summary: " + json.dumps({**summary10, "card": card}))

    # -- 11. result lines --------------------------------------------------------
    meta = {
        "rollout": ("safe_grid_agents_torch/csrc/rollout_kernel.cu",
                    "safe_grid_agents_tpu/ops/rollout_kernel.py:57"),
        "tabq": ("safe_grid_agents_torch/csrc/tabular_kernel.cu",
                 "safe_grid_agents_tpu/ops/tabular_kernel.py:47"),
        "dqn_collect": ("safe_grid_agents_torch/csrc/dqn_kernel.cu",
                        "safe_grid_agents_tpu/ops/dqn_kernel.py:87"),
        "dqn_update": ("safe_grid_agents_torch/csrc/dqn_update_kernel.cu",
                       "safe_grid_agents_tpu/ops/dqn_update_kernel.py:54"),
        "dqn_update_grid": ("safe_grid_agents_torch/csrc/dqn_update_grid.cu",
                             "safe_grid_agents_tpu/ops/dqn_update_kernel.py:54"),
        "ppo_collect": ("safe_grid_agents_torch/csrc/ppo_collect_kernel.cu",
                        "safe_grid_agents_tpu/ops/ppo_collect_kernel.py:47"),
        "ppo_optimize": ("safe_grid_agents_torch/csrc/ppo_kernel.cu",
                         "safe_grid_agents_tpu/ops/ppo_kernel.py:62"),
        "ppo_wide": ("safe_grid_agents_torch/csrc/ppo_wide_kernel.cu",
                     "safe_grid_agents_tpu/ops/ppo_kernel.py:62"),
        "fused_mlp": ("safe_grid_agents_torch/csrc/fused_mlp.cu",
                      "safe_grid_agents_tpu/ops/fused_mlp.py:47"),
        "stoch_rollout": ("safe_grid_agents_torch/csrc/stoch_rollout_kernel.cu",
                          "safe_grid_agents_tpu/ops/stoch_rollout_kernel.py:76"),
        "tabq_stoch": ("safe_grid_agents_torch/csrc/tabular_stoch_kernel.cu",
                       "safe_grid_agents_tpu/ops/tabular_stoch_kernel.py:51"),
        "dqn_stoch_collect": ("safe_grid_agents_torch/csrc/dqn_stoch_kernel.cu",
                              "safe_grid_agents_tpu/ops/dqn_stoch_kernel.py:43"),
        "ppo_stoch_collect": ("safe_grid_agents_torch/csrc/ppo_stoch_collect_kernel.cu",
                              "safe_grid_agents_tpu/ops/ppo_stoch_collect_kernel.py:47"),
        # B1 and B7 under the reference's shard_map: the same kernels on each
        # rank's lanes (phase 9).
        "rollout_sharded": ("safe_grid_agents_torch/csrc/rollout_kernel.cu",
                            "safe_grid_agents_tpu/ops/rollout_kernel.py:287"),
        "stoch_rollout_sharded": ("safe_grid_agents_torch/csrc/stoch_rollout_kernel.cu",
                                  "safe_grid_agents_tpu/ops/stoch_rollout_kernel.py:380"),
    }
    # The device-memory placements of B1, B2, B3 and B5: the same sources and
    # TPU kernels as their shared-memory rows.
    for name in ("rollout", "tabq", "dqn_collect", "ppo_collect"):
        meta[f"{name}_global"] = meta[name]
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "env_steps_per_s": r.get("rate"), "shapes": r["shapes"],
        }
        if "device_ms" in r:
            entry["device_ms"] = r["device_ms"]
        if f"{name}_wide" in results:
            entry["wide"] = results[f"{name}_wide"]
        if "cases" in r:
            entry["cases"] = r["cases"]
        for extra in ("ab_parent", "launch_split", "bound_fp32_ms", "bound_fp32_by",
                      "array_path", "agent_gates", "update_cost", "resume", "checkpoint",
                      "single_ms"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
