"""The port's package namespaces against the reference's.

Each package ``repro.<pkg>`` re-exports names from its submodules in its
``__init__`` (``from repro.scaling import get_controller``). For every
package the port has, each name the reference's ``__init__`` imports
must be an attribute of ``repro_torch.<pkg>`` whenever its counterpart
exists in the port (the submodule, or the name in the port's copy of the
module it comes from): code written against the reference's namespace
then runs on the port. The reference's ``__init__`` files are read as
source, so this holds whatever else a test session has imported.
"""
import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

REF_ROOT = Path(importlib.util.find_spec("repro.scaling").origin).parents[1]
PACKAGES = sorted(p.parent.name for p in REF_ROOT.glob("*/__init__.py")
                  if importlib.util.find_spec(f"repro_torch.{p.parent.name}"))


def _exports(pkg: str) -> list[tuple[str, str | None]]:
    """(name, module it comes from, None for a submodule) for each name
    the reference package's ``__init__`` imports at its top level."""
    tree = ast.parse((REF_ROOT / pkg / "__init__.py").read_text())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or node.module is None:
            continue
        for alias in node.names:
            if node.module == f"repro.{pkg}":
                out.append((alias.asname or alias.name, None))
            elif node.module.startswith(f"repro.{pkg}."):
                out.append((alias.asname or alias.name,
                            node.module.split(".", 2)[2]))
    return out


def _ported(pkg: str, name: str, module: str | None) -> bool:
    if module is None:
        return importlib.util.find_spec(f"repro_torch.{pkg}.{name}") \
            is not None
    if importlib.util.find_spec(f"repro_torch.{pkg}.{module}") is None:
        return False
    return hasattr(importlib.import_module(f"repro_torch.{pkg}.{module}"),
                   name)


def test_the_ported_packages_are_found():
    assert {"aapaset", "configs", "core", "dist", "evals", "forecast",
            "kernels", "obs", "scaling", "tuning"} <= set(PACKAGES)


@pytest.mark.parametrize("pkg,modules", [
    ("models", ["common", "layers", "moe", "ssm", "transformer", "encdec",
                "model"]),
    ("configs", ["registry", "deepseek_67b", "deepseek_v2_lite_16b",
                 "internlm2_1_8b", "internvl2_76b", "mamba2_2_7b",
                 "mistral_nemo_12b", "qwen3_moe_30b_a3b", "stablelm_1_6b",
                 "whisper_large_v3", "zamba2_2_7b"]),
    ("dist", ["sharding"]),
    ("serve", ["engine"]),
    ("launch", ["serve"])])
def test_serving_slice_modules_mirror_the_reference(pkg, modules):
    """The serving slice's packages sit where the reference's do, with
    the reference's module names; each ported module's public functions
    and classes are the reference's names (the reference's ``models``,
    ``serve`` and ``launch`` have no ``__init__`` to re-export from)."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert port.__file__ is not None          # a regular package
    for name in modules:
        assert (REF_ROOT / pkg / f"{name}.py").exists(), (pkg, name)
        mod = importlib.import_module(f"repro_torch.{pkg}.{name}")
        tree = ast.parse((REF_ROOT / pkg / f"{name}.py").read_text())
        public = [n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_")]
        if pkg == "launch":                   # the launcher's entry point
            public = ["main"]
        missing = [n for n in public if not hasattr(mod, n)]
        assert not missing, f"repro_torch.{pkg}.{name} lacks {missing}"


@pytest.mark.parametrize("pkg,modules", [
    ("train", ["optimizer", "train_step", "checkpoint"]),
    ("launch", ["serve", "train", "specs", "dryrun", "roofline", "mesh"])])
def test_training_slice_modules_mirror_the_reference(pkg, modules):
    """Training and the launch tools sit where the reference's do, with
    its module names, and each module has every public function and class
    of the reference's (``launch.train`` and ``launch.serve``: ``main``)."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert port.__file__ is not None          # a regular package
    for name in modules:
        mod = importlib.import_module(f"repro_torch.{pkg}.{name}")
        tree = ast.parse((REF_ROOT / pkg / f"{name}.py").read_text())
        public = [n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_")]
        missing = [n for n in public if not hasattr(mod, n)]
        assert public and not missing, \
            f"repro_torch.{pkg}.{name} lacks {missing}"


def test_the_port_has_every_reference_module():
    """The two trees' module lists differ only by the port's own helpers
    (``dist/collectives`` and ``dist/world``: the per-rank collectives
    and the spawned world that stand in for the reference's GSPMD)."""
    def modules(root):
        return {str(p.relative_to(root).with_suffix(""))
                for p in root.rglob("*.py")}
    port_root = Path(importlib.util.find_spec("repro_torch").origin).parent
    ref, port = modules(REF_ROOT), modules(port_root)
    assert ref - port == set()
    assert {m for m in port - ref if not m.endswith("__init__")} == {
        "_device", "_numerics", "interop", "kernels/_build",
        "kernels/policy_signals", "dist/collectives", "dist/world"}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_reexports_match_reference(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    wanted = [(n, m) for n, m in _exports(pkg) if _ported(pkg, n, m)]
    missing = [n for n, _ in wanted if not hasattr(port, n)]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    if pkg in ("scaling", "forecast", "evals"):
        assert len(wanted) >= 5


@pytest.mark.parametrize("pkg,names", [
    ("scaling", ["Controller", "LimiterState", "Obs", "ScaleAction",
                 "apply_decision", "limiter_init", "available",
                 "get_controller"]),
    ("forecast", ["Forecaster", "FState", "Interval", "interval_confidence",
                  "make_forecaster", "backtest", "conformal", "registry"]),
    ("evals", ["artifacts", "fleet", "matrix", "metrics", "rei",
               "EvalResult", "MatrixRun", "MatrixSpec", "run", "smoke_spec",
               "spec"]),
    ("aapaset", ["AAPAsetLoader", "BuiltDataset", "DatasetConfig",
                 "build_or_load", "config_hash", "dataset_card",
                 "featurize_windows", "get", "is_cached", "read_manifest",
                 "available", "register"])])
def test_named_reexports(pkg, names):
    """The names the reference's namespaces are used by, each the port's
    own object from its submodule."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    for name in names:
        obj = getattr(port, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")) \
            .startswith(f"repro_torch.{pkg}"), name


def test_controllers_shim_reexports_the_policies():
    from repro.core import controllers as ref_shim
    from repro_torch.core import controllers as shim
    from repro_torch.scaling import api, policies
    assert shim.__all__ == ref_shim.__all__
    for name in shim.__all__:
        assert getattr(shim, name) is (getattr(policies, name, None)
                                       or getattr(api, name))
