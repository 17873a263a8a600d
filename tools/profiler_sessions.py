"""How many CUDA kernels torch.profiler records, session after session, in
one process on one CUDA card: a long step (``--big`` launches of a
512 x 512 matmul and a tanh, read through ``key_averages`` as chip_smoke's
StepProbe reads a train step), then RuntimeProfiler over 2 steps of 2
launches (read from its Chrome trace, as chip_smoke's profiler_hook reads
it), again and again, with what chip_smoke.py does between its profiled
phases in the middle: two spawned processes on the card, a one-process
NCCL group with an all-reduce, and a thread of CPU work that runs through
the sessions. Each kind of session is held to the launches it made.

    python3 tools/profiler_sessions.py [--cycles N] [--big K]

runs the sequence twice, each in a process of its own: as torch sets
CUPTI up (it tears CUPTI down after every session), then with
``TEARDOWN_CUPTI=0``. Prints the card's name and power limit first, a
JSON line a session, and last a JSON summary: for each setting, the
sessions whose recorded kernels fall short of their launches.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def card_work(rank, x_size=512, reps=200):
    """A spawned process's matmuls on the card."""
    x = torch.randn(x_size, x_size, device="cuda")
    for _ in range(reps):
        x = torch.tanh(x @ x)
    torch.cuda.synchronize()


def launches(x, k):
    """``k`` matmuls and tanhs on the card: 2 k kernels."""
    for _ in range(k):
        x = torch.tanh(x @ x)
    return x


def long_session(x, k):
    """StepProbe's way: a profile around ``k`` steps, its device kernels
    from key_averages."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launches(x, k)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
               and not e.is_user_annotation)


def hook_session(x, save_path):
    """profiler_hook's way: RuntimeProfiler over steps 1 and 2 of 4, the
    kernel events of its Chrome trace."""
    from scenesplat_tpu_torch.engines.hooks import HOOKS
    from scenesplat_tpu_torch.utils.config import Config
    from scenesplat_tpu_torch.utils.events import EventStorage

    hook = HOOKS.build(dict(type="RuntimeProfiler", start_step=1, num_steps=2))
    hook.trainer = types.SimpleNamespace(cfg=Config(dict(save_path=save_path)),
                                         device=torch.device("cuda"), storage=EventStorage(),
                                         logger=logging.getLogger("profiler_sessions"))
    for step in range(4):
        hook.trainer.storage.iter = step
        hook.before_step()
        x = torch.tanh(x @ x)
        hook.after_step()
    with open(hook.trace_path) as f:
        return sum(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])


def child(cycles, big):
    """The sequence in this process: a JSON line a session."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn(512, 512, device="cuda") / 512 ** 0.5
    # the kernels one step makes here, from a second session of 10 steps
    # (the first pays the profiler's start)
    long_session(x, 1)
    per_step = long_session(x, 10) / 10
    stop = threading.Event()
    cpu_thread = None
    work = tempfile.mkdtemp()
    for cycle in range(cycles):
        between = None
        if cycle == cycles // 4:
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=card_work, args=(r,)) for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join()
            between = f"spawned 2 card processes (exit codes {[p.exitcode for p in procs]})"
        elif cycle == cycles // 2:
            import torch.distributed as dist

            dist.init_process_group("nccl", init_method="tcp://localhost:29533", rank=0,
                                    world_size=1)
            t = torch.ones(1 << 20, device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            dist.destroy_process_group()
            between = "one-process NCCL group, one all-reduce"
        elif cycle == 3 * cycles // 4:
            def cpu_loop():
                y = torch.randn(256, 256)
                while not stop.is_set():
                    y = torch.tanh(y @ y)

            cpu_thread = threading.Thread(target=cpu_loop, daemon=True)
            cpu_thread.start()
            between = "a thread of CPU matmuls from here on"
        got_long = long_session(x, big)
        got_hook = hook_session(x, os.path.join(work, str(cycle)))
        print(json.dumps(dict(cycle=cycle, between=between, long_kernels=got_long,
                              long_expected=big * per_step, hook_kernels=got_hook,
                              hook_expected=2 * per_step)), flush=True)
    stop.set()
    if cpu_thread is not None:
        cpu_thread.join()
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cycles", type=int, default=24)
    parser.add_argument("--big", type=int, default=500)
    parser.add_argument("--child", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        return child(args.cycles, args.big)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    summary = {}
    for name, env in (("default", {}), ("TEARDOWN_CUPTI=0", {"TEARDOWN_CUPTI": "0"})):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               "--cycles", str(args.cycles), "--big", str(args.big)],
                              capture_output=True, text=True, env=dict(os.environ, **env),
                              timeout=600)
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        for row in rows:
            print(json.dumps(dict(setting=name, **row)), flush=True)
        short = [dict(cycle=r["cycle"], long=[r["long_kernels"], r["long_expected"]],
                      hook=[r["hook_kernels"], r["hook_expected"]]) for r in rows
                 if r["long_kernels"] < r["long_expected"]
                 or r["hook_kernels"] < r["hook_expected"]]
        summary[name] = dict(rc=proc.returncode, sessions=len(rows), short=short,
                             stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
