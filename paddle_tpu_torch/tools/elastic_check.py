"""Elastic scale-in and the planner's rank order on the cards of one host
(the four-card check of the sharding planner and the resharded resume).

    python -m paddle_tpu_torch.tools.elastic_check

It needs four cards; every rank holds one.

1. **Scale-in** through the port's launcher
   (``paddle_tpu_torch.testing._elastic_train``): Llama-3-8B widths at
   1 layer, bf16, AdamW, a global batch of 4 x 4096 tokens,
   dp2_tp2 on 4 ranks with one save at step 4 (the sharded checkpoint:
   every rank its own shards) and an exit 137 at step 6; then a fresh
   2-rank pod re-plans (``--plan-auto``, candidates dp1_tp2 and dp2_tp1)
   and resumes from step 4 through the resharded restore. Gates: the
   restored parameters, gathered, equal the saved step-4 state by
   digest; the resumed steps 5–6 are within 1e-2 of the killed leg's
   logged losses (another mesh: another bf16 summation order); every
   training kernel launched in the resumed steps. Reported: the save's
   and the restore's seconds and GB/s.
2. **Rank order**: ``tools/plan.py --validate`` on a 4-rank pod at
   Llama-3-8B widths, 2 layers, 4 x 4096 tokens, candidates dp4 and tp4
   (``tools/mesh_check.py``'s timed layouts): each config's predicted
   and measured step and the rank agreement. Reported, not gated on
   its agreement; a pod that fails or writes no report fails the check.

Everything goes to ``chiprun_out/elastic_check.json`` with the card's
name and power limit, the ranks' logs to ``chiprun_out/elastic_logs``;
the checkpoints (17.8 GB a save at 1 layer) are written under
``build/elastic_ckpt`` and removed at the end. Exits 1 when a gate
fails.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

TRAINING_KERNELS = ("rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd",
                    "flash_bwd", "vocab_ce_fwd", "vocab_ce_dlog",
                    "vocab_ce_dh", "vocab_ce_dw")
LOSS_TOL = 1e-2
#: the model layers of the scale-in and of the rank order
SCALE_IN_LAYERS = 1
RANK_ORDER_LAYERS = 2
LEG_TIMEOUT_S = 1500


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _leg(root, world, extra, common):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.testing._elastic_train",
           "--ckpt-dir", root, "--virtual-devices", str(world), *common,
           *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=LEG_TIMEOUT_S)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("ELASTIC_RESULT "):
            result = json.loads(line[len("ELASTIC_RESULT "):])
    return proc.returncode, result, time.perf_counter() - t0, \
        (proc.stdout + proc.stderr)[-3000:]


def _segment(root, attempt=0):
    path = os.path.join(root, "_elastic", f"segment_{attempt}.json")
    with open(path) as f:
        return json.load(f)


def scale_in(root):
    """Part 1. Returns (results, failures)."""
    common = ["--preset", "llama3_8b", "--layers", str(SCALE_IN_LAYERS),
              "--dtype", "bfloat16", "--global-batch", "4", "--seq-len",
              "4096", "--lr", "1e-4", "--steps", "6",
              "--save-interval", "4", "--report", "--no-digest"]
    shutil.rmtree(root, ignore_errors=True)
    out, fails = {}, []
    rc, _, secs, tail = _leg(root, 4, ["--config", "dp2_tp2",
                                       "--hard-exit-at", "6"], common)
    killed = _segment(root)
    out["killed"] = {"exit_code": rc, "seconds": secs,
                     "config": killed["config"], "steps": killed["steps"],
                     "losses": killed["losses"]}
    if rc != 137:
        fails.append(f"the killed leg exited {rc}: {tail}")
    rc, res, secs, tail = _leg(root, 2, ["--plan-auto", "--candidates",
                                         "dp1_tp2,dp2_tp1"], common)
    if rc != 0 or res is None:
        fails.append(f"the resumed leg exited {rc}: {tail}")
        return out, fails
    seg = res["segments"][0]
    rest = seg.get("restore", {})
    save = next((s for s in killed.get("saves", [])), None)
    resumed = dict(zip(seg["steps"], seg["losses"]))
    before = dict(zip(killed["steps"], killed["losses"]))
    diffs = {s: abs(resumed[s] - before[s]) for s in (5, 6)
             if s in resumed and s in before}
    missing = [k for k in TRAINING_KERNELS
               if seg.get("launches", {}).get(k, 0) <= 0]
    out["resumed"] = {
        "exit_code": rc, "seconds": secs, "config": seg["config"],
        "steps": seg["steps"], "losses": seg["losses"],
        "loss_diff_vs_killed": diffs, "restore": rest,
        "restore_GB_per_s": (rest["checkpoint_bytes"] / rest["seconds"]
                             / 1e9 if rest.get("seconds") else None),
        "launches": seg.get("launches"), "missing_kernels": missing}
    if save is not None:
        out["save"] = dict(save, GB_per_s=(
            save["bytes"] / save["write_s"] / 1e9
            if save.get("write_s") else None))
    if (rest.get("gathered_digest") != rest.get("saved_digest")
            or rest.get("step") != 4):
        fails.append(f"restored state differs from step 4's: {rest}")
    if len(diffs) < 2 or max(diffs.values()) > LOSS_TOL:
        fails.append(f"resumed losses off the killed leg's: {diffs}")
    if missing:
        fails.append(f"kernels not launched: {missing}")
    return out, fails


def rank_order(logdir):
    """Part 2: the validation under a 4-rank pod. Returns (its verdict,
    failures): the agreement is reported, a pod that fails or writes no
    report is a failure."""
    path = os.path.join(logdir, "plan_report.json")
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--log_dir", logdir,
           os.path.join(_REPO, "paddle_tpu_torch", "tools", "plan.py"),
           "--model", "llama3-8b", "--layers", str(RANK_ORDER_LAYERS),
           "--batch", "4", "--seq", "4096", "--mesh", "4",
           "--candidates", "dp4,tp4", "--drift", "ignore", "--validate",
           "--out", path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=LEG_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(path):
        tail = (proc.stdout + proc.stderr)[-2000:]
        return ({"exit_code": proc.returncode, "seconds": secs,
                 "tail": tail},
                [f"the rank-order pod exited {proc.returncode} "
                 f"(report written: {os.path.exists(path)}): {tail}"])
    with open(path) as f:
        rep = json.load(f)
    return {"exit_code": 0, "seconds": secs,
            "validation": rep.get("validation"),
            "predicted": {r["config"]: r["predicted_step_s"]
                          for r in rep["ranked"]},
            "device": rep["device"]}, []


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="elastic_check")
    p.add_argument("--out-dir", default=os.path.join(_REPO, "chiprun_out"))
    args = p.parse_args(argv)
    from paddle_tpu_torch.device import device_info
    card = device_info()
    print(card, flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    res = {"card": card}
    # the checkpoints stay out of the output directory; the ranks' logs
    # are copied there
    root = os.path.join(_REPO, "build", "elastic_ckpt")
    try:
        res["scale_in"], fails = scale_in(root)
    finally:
        logs = os.path.join(root, "_elastic")
        if os.path.isdir(logs):
            shutil.copytree(logs, os.path.join(args.out_dir,
                                               "elastic_logs"),
                            dirs_exist_ok=True)
        shutil.rmtree(root, ignore_errors=True)
    print("scale-in: " + json.dumps(res["scale_in"], default=str),
          flush=True)
    res["rank_order"], rank_fails = rank_order(
        os.path.join(args.out_dir, "elastic_rank_order"))
    fails += rank_fails
    print("rank order: " + json.dumps(res["rank_order"], default=str),
          flush=True)
    res["failures"] = fails
    with open(os.path.join(args.out_dir, "elastic_check.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(json.dumps({"ok": not fails, "failures": fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
