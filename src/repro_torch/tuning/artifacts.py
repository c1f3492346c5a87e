"""Content-addressed tuning cards + the ``tuned:`` registry namespace
(port of ``repro.tuning.artifacts``).

A tuning card is addressed by the sha256 of its content key — the full
``TuneSpec`` plus the classifier id — on the scheme of
``aapaset.manifest`` (canonical-JSON sha256, atomic staged publish): the
reference's hash under the port's own root, since a candidate's REI
differs from the reference's in the last digits and one address must not
name both packages' cards. `resolve(ref, root=...)` reads a card of
either.

Layout under ``experiments/tuning_torch/<name>-<hash12>/``:

* ``card.json`` — key, hash, policy, best point, default point + REI
  delta, the full search trace (per round) and per-candidate REI table,
  throughput meta.

The card hash is also the winner's durable address:
``registry.make(f"tuned:<policy>@<hash12>", cfg)`` resolves the card via
``resolve`` and rebuilds the tuned controller exactly (stored
hyperparameters applied over registry defaults — bit-identical to the
search-time build).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil

from repro_torch.aapaset.manifest import hash_json, publish_dir, stage_dir

DEFAULT_ROOT = pathlib.Path("experiments/tuning_torch")


def card_hash(key: dict) -> str:
    return hash_json(key)


def result_dir(name: str, key: dict,
               root: pathlib.Path | str = DEFAULT_ROOT) -> pathlib.Path:
    return pathlib.Path(root) / f"{name}-{card_hash(key)}"


def is_cached(name: str, key: dict,
              root: pathlib.Path | str = DEFAULT_ROOT) -> bool:
    return (result_dir(name, key, root) / "card.json").exists()


def save_run(spec, key: dict, result,
             root: pathlib.Path | str = DEFAULT_ROOT, *,
             replace: bool = False) -> dict:
    """Publish a TuneResult as card.json; returns the card.

    `replace=True` (a forced re-run) clears the existing artifact first —
    publish_dir's same-address race rule would otherwise keep the old
    copy and drop the fresh one."""
    out = result_dir(spec.name, key, root)
    tmp = stage_dir(out)
    card = {
        "schema": key.get("schema"),
        "key": key,
        "hash": card_hash(key),
        "policy": spec.policy,
        "spec": dataclasses.asdict(spec),
        "best": result.best,
        "best_rei": result.best_rei,
        "best_metrics": result.best_metrics,
        "default": result.default,
        "default_rei": result.default_rei,
        "rei_delta": result.best_rei - result.default_rei,
        "trace": result.trace,
        "table": result.table,
        "meta": result.meta,
    }
    with open(tmp / "card.json", "w") as f:
        json.dump(card, f, indent=1, default=float)
    if replace:
        shutil.rmtree(out, ignore_errors=True)
    publish_dir(tmp, out, "card.json")
    return card


def load_card(name: str, key: dict,
              root: pathlib.Path | str = DEFAULT_ROOT) -> dict:
    with open(result_dir(name, key, root) / "card.json") as f:
        return json.load(f)


def result_from_card(spec, card: dict):
    """Rebuild the TuneResult view of a cached card (cache-hit path of
    ``search.search``; `meta` keeps the original run's throughput)."""
    from repro_torch.tuning.search import TuneResult
    return TuneResult(
        spec=spec, best=card["best"], best_rei=card["best_rei"],
        best_metrics=card["best_metrics"], default=card["default"],
        default_rei=card["default_rei"], table=card["table"],
        trace=card["trace"], meta=dict(card["meta"], cached=True))


def list_cards(root: pathlib.Path | str = DEFAULT_ROOT) -> list[dict]:
    """Every published tuning card under `root` (sorted by dir name)."""
    root = pathlib.Path(root)
    cards = []
    if root.is_dir():
        for p in sorted(root.glob("*/card.json")):
            with open(p) as f:
                cards.append(json.load(f))
    return cards


def resolve(ref: str,
            root: pathlib.Path | str | None = None) -> tuple[str, dict]:
    """``"<policy>@<hash12>"`` -> (policy, tuned hyperparameters).

    The hash addresses the card directory (`<name>-<hash12>`); the policy
    part is cross-checked against the card so a copy-pasted ref can't
    silently rebuild the wrong controller family. `root` defaults to
    `DEFAULT_ROOT` at call time (tests repoint the module attribute)."""
    if root is None:
        root = DEFAULT_ROOT
    if "@" not in ref:
        raise ValueError(f"tuned ref {ref!r} must look like "
                         "'<policy>@<hash12>'")
    policy, _, h = ref.partition("@")
    root = pathlib.Path(root)
    hits = sorted(root.glob(f"*-{h}/card.json")) if root.is_dir() else []
    if not hits:
        raise FileNotFoundError(
            f"no tuning card with hash {h!r} under {root} — run "
            "repro_torch.tuning.search() first, or point root= at the "
            "experiments directory that holds it")
    with open(hits[0]) as f:
        card = json.load(f)
    if card.get("policy") != policy:
        raise ValueError(
            f"tuned ref {ref!r} names policy {policy!r} but card "
            f"{card.get('hash')} tuned {card.get('policy')!r}")
    # JSON round-trip keeps float64 repr exact and ints int; static keys
    # were canonicalized at proposal time, so this rebuilds bit-exactly.
    return policy, dict(card["best"])
