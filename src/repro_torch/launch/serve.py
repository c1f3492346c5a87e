"""Serving launcher: an AAPA-autoscaled model endpoint for any --arch
(port of ``repro.launch.serve`` with the serving demo's loop).

    python -m repro_torch.launch.serve --arch stablelm_1_6b --minutes 10

A reduced (``configs.smoke_config``) model of the arch serves batched
requests whose arrivals follow a bursty synthetic trace (120/min, 2000/min
in the middle minute); any ``repro_torch.scaling`` policy scales its
replica lanes through ``scaling.adapter``, the controller code the
cluster simulator runs. The AAPA classifier is trained on ``aapaset_ci``
(cached after the first run) and classifies through ``kernels.ops``: the
``window_features`` and ``gbdt_tables`` kernels on the card. Everything
runs on the card unless ``--device cpu`` is given.

``--dry-run`` runs ``launch.dryrun.run_cell`` for ``--shape`` (default
``decode_32k``) and exits 0 or 1 on its ``ok``, as the reference's
launcher does; ``--multi-pod`` (the reference's 2x16x16 mesh across
hosts) exits with an error.

`serve` runs unchanged inside a ``torch.distributed`` world of one process
a card (``dist.world.spawn``) whose world mesh is active: the engine
shards the model over it, every rank runs the same schedule and
decisions, and only rank 0 logs.
"""
from __future__ import annotations

import argparse

import numpy as np

STEPS_PER_MIN = 20     # one simulated trace-minute = 1 s of engine time
MINUTE_S = 1.0


def _quiet(*_args, **_kw) -> None:
    return None


def _logger(log):
    """`log` on rank 0 of a ``torch.distributed`` world (or outside one),
    else a logger that prints nothing."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_rank() != 0:
        return _quiet
    return log


def bursty_rates(minutes: int) -> np.ndarray:
    """The launcher's arrival trace: 120 requests/min, with 2000/min in the
    middle minute."""
    rates = np.full(minutes, 120.0)
    rates[minutes // 2] = 2000.0
    return rates


def serve(minutes: int, policy: str, trained, params, cfg, rates, rng, *,
          device="cuda", classify=None, log=print):
    """Serve `minutes` of `rates` (requests per logical minute) under
    `policy`: returns the (engine, autoscaler) after the run. `classify`
    defaults to `trained`'s classifier."""
    from repro_torch.core.archetypes import ARCHETYPE_NAMES
    from repro_torch.scaling import adapter, registry
    from repro_torch.serve.engine import Request, ServingEngine

    log = _logger(log)
    eng = ServingEngine(cfg, params, lanes_per_replica=4, max_replicas=8,
                        step_time_s=MINUTE_S / STEPS_PER_MIN,
                        startup_s=2.0, slo_s=1.5, device=device)
    sim_cfg = adapter.sim_config_for_engine(eng, minute_s=MINUTE_S)
    name = {"reactive": "hpa"}.get(policy, policy)
    if classify is None and trained is not None:
        classify = trained.make_classify()
    ctrl = registry.get_controller(name, sim_cfg, classify=classify)
    auto = adapter.EngineAutoscaler(eng, ctrl, sim_cfg, minute_s=MINUTE_S)

    rid = 0
    for minute in range(minutes):
        n_req = int(rng.poisson(rates[minute] / 60.0))
        for _ in range(STEPS_PER_MIN):
            burst = (n_req // STEPS_PER_MIN
                     + (rng.random() < (n_req % STEPS_PER_MIN)
                        / STEPS_PER_MIN))
            for _ in range(int(burst)):
                eng.submit(Request(rid, eng.t, prompt_len=4,
                                   gen_len=int(rng.integers(2, 6))))
                rid += 1
            eng.step()
            auto.on_tick()
        if minute % 5 == 0:
            arch = getattr(auto.ctrl_state, "arch", None)
            label = ARCHETYPE_NAMES[int(arch)] if arch is not None else "-"
            log(f"  min {minute:3d} rate={rates[minute]:7.1f}/min "
                f"arch={label:12s} replicas={eng.ready_replicas}"
                f"+{len(eng.starting)} queue={len(eng.queue)}")
    return eng, auto


def run(minutes: int, policy: str, trained, params, cfg, rates, rng, *,
        device="cuda") -> dict:
    """The serving demo's run: serve, print why it scaled, and return the
    engine's summary."""
    eng, auto = serve(minutes, policy, trained, params, cfg, rates, rng,
                      device=device)
    print_why_scaled(auto.decision_trace(), log=_logger(print))
    return eng.summary()


def print_why_scaled(trace, log=print) -> None:
    """'Why scaled' digest of the adapter's DecisionRecord log: every
    executed action with the signals that drove it."""
    n = len(trace.desired)
    moves = np.nonzero((trace.scale_up > 0.5) | (trace.scale_down > 0.5)
                       | (trace.cooldown_blocked > 0.5))[0]
    log(f"  why scaled: {len(moves)} actions over {n} decisions")
    for i in moves[:12]:
        kind = ("up" if trace.scale_up[i] > 0.5 else
                "down" if trace.scale_down[i] > 0.5 else "held(cooldown)")
        fc = (f" fc={trace.fc_point[i]:.0f}/min"
              if np.isfinite(trace.fc_point[i]) else "")
        log(f"    min {int(trace.minute[i]):3d} {kind:14s} "
            f"ready={trace.ready[i]:.0f} -> target={trace.target[i]:.0f}"
            f" rate={trace.rate_rps[i]:.1f}/s{fc}")
    if len(moves) > 12:
        log(f"    ... {len(moves) - 12} more")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--minutes", type=int, default=10)
    ap.add_argument("--policy", default="aapa",
                    help="any repro_torch.scaling registry policy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.multi_pod:
        from repro_torch.dist import sharding as shd
        raise SystemExit(str(shd.unsupported("--multi-pod (the 2x16x16 "
                                             "mesh)")))
    if args.dry_run:
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell(args.arch, args.shape)
        raise SystemExit(0 if rec.get("ok") else 1)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import gbdt, pipeline
    from repro_torch.models import model as M
    from repro_torch.scaling import registry

    if args.policy not in ("reactive", *registry.available()):
        raise SystemExit(f"unknown --policy {args.policy!r}; "
                         f"available: {registry.available()}")

    cfg = smoke_config(get_config(args.arch))
    params = M.init(0, cfg, device=args.device)
    trained = pipeline.train_classifier(
        "aapaset_ci", gbdt.GBDTConfig(n_rounds=10, depth=3),
        device=args.device)
    print(f"[serve] {cfg.name} classifier on {trained.dataset_id} "
          f"acc={trained.test_acc:.3f}")

    rng = np.random.default_rng(0)
    s = run(args.minutes, args.policy, trained, params, cfg,
            bursty_rates(args.minutes), rng, device=args.device)
    print(f"[serve] {s}")


if __name__ == "__main__":
    main()
