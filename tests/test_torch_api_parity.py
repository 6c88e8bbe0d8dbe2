"""Every public name of the JAX package has a counterpart in the port.

The JAX sources are read with ``ast`` (nothing of the JAX package is
imported here).  Four checks:

* each subpackage ``__init__`` of the JAX package exports nothing the
  port's same subpackage lacks;
* each module of the JAX package has a port module at the same path
  holding every public top-level function, class and constant;
* each public class there has every public method and property of the
  JAX class;
* the functions of ``SIGNATURES`` take the JAX function's parameters, by
  name and in order.

The deliberate exclusions are listed below, each with its reason.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "irotavg_tpu")

SUBPACKAGES = ("ops", "matching", "geometry", "frontend", "solver", "engine",
               "placerec", "parallel", "pipeline", "utils")

# JAX modules with no port module, and why
EXCLUDED_MODULES = {
    # the Pallas entry (pallas_call) with its ±1 bf16 descriptor expansion
    # (unpack_pm1) and backend switch (use_pallas): a TPU workaround; the
    # port's matcher is ops/match.py with csrc/match_best2.cu
    "ops/match_pallas.py",
    # the C++ helpers (vocabulary parser, spanning-tree sweep, L1 scorer),
    # replaced by numpy routes that the port's tests hold bit-equal
    "native/__init__.py",
    # the XLA compilation cache (enable_persistent_cache)
    "utils/cache.py",
}

# public names of kept modules with no counterpart, and why
EXCLUDED_NAMES = {
    # Frame.pm1: the cached ±1 bf16 expansion the Pallas kernel reads;
    # the CUDA kernel reads the (N, 8) int32 words
    ("frontend/frame.py", "Frame.pm1"),
    # the banded-matrix blur of ops/image.py (_band_matrix, _sep_blur) is
    # private, so never checked: the port sums the separable taps
}


def _modules():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_PKG))
    return sorted(out)


def _port_module(rel):
    name = "irotavg_tpu_torch." + rel[:-3].replace(os.sep, ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def _tree(rel):
    with open(os.path.join(JAX_PKG, rel)) as fh:
        return ast.parse(fh.read())


def _public(name):
    return not name.startswith("_")


def _top_level(tree):
    """Public functions, classes and assigned constants of a module."""
    names, classes = [], {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if _public(node.name):
                names.append(node.name)
            if isinstance(node, ast.ClassDef) and _public(node.name):
                classes[node.name] = [
                    n.name for n in node.body
                    if isinstance(n, ast.FunctionDef) and _public(n.name)]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and _public(t.id)]
    return names, classes


def _exports(tree):
    """Names a subpackage ``__init__`` imports or lists in ``__all__``."""
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names |= {e.value for e in node.value.elts}
    return sorted(n for n in names if _public(n))


# the names that EXCLUDED_MODULES drops from the subpackage exports
_EXCLUDED_EXPORTS = {"enable_persistent_cache"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_have_counterparts(sub):
    names = _exports(_tree(os.path.join(sub, "__init__.py")))
    assert names, sub
    port = importlib.import_module(f"irotavg_tpu_torch.{sub}")
    missing = [n for n in names
               if n not in _EXCLUDED_EXPORTS and not hasattr(port, n)]
    assert missing == []


@pytest.mark.parametrize("rel", [m for m in _modules()
                                 if m not in EXCLUDED_MODULES])
def test_module_names_have_counterparts(rel):
    names, classes = _top_level(_tree(rel))
    port = _port_module(rel)
    missing = [n for n in names if not hasattr(port, n)]
    for cls, methods in classes.items():
        pc = getattr(port, cls, None)
        missing += [f"{cls}.{m}" for m in methods
                    if (rel, f"{cls}.{m}") not in EXCLUDED_NAMES
                    and not hasattr(pc, m)]
    assert missing == []


def test_exclusions_name_what_exists():
    """Every exclusion names a module and a name the JAX package has, and
    the port really lacks the excluded modules."""
    mods = set(_modules())
    assert EXCLUDED_MODULES <= mods
    for rel in EXCLUDED_MODULES:
        with pytest.raises(ImportError):
            _port_module(rel)
    for rel, dotted in EXCLUDED_NAMES:
        cls, name = dotted.split(".")
        assert name in _top_level(_tree(rel))[1][cls]
        assert not hasattr(getattr(_port_module(rel), cls), name)
    cache_exports = _top_level(_tree("utils/cache.py"))[0]
    assert _EXCLUDED_EXPORTS <= set(cache_exports)
    image = {n.name for n in _tree("ops/image.py").body
             if isinstance(n, ast.FunctionDef)}
    assert {"_band_matrix", "_sep_blur"} <= image


# Functions whose parameters follow the JAX package's name for name.  The
# port passes a frame's arrays as one tuple where the JAX function takes
# them one by one: each such group of JAX names maps to the port's tuple
# parameter.  ``device`` is the port's only extra (its entry points run on
# the card unless asked otherwise).
_FRAME_C = ("bits_c", "nodes_c", "valid_c", "angle_c", "x_c", "y_c", "oct_c")
_FRAME_P = ("bits_p", "nodes_p", "valid_p", "angle_p", "x_p", "y_p", "oct_p")
SIGNATURES = {
    ("geometry/essential.py", "ransac_essential"): {},
    ("so3.py", "random_quat"): {},
    ("geometry/fused.py", "fused_bow_pair_estimate"): {
        "f1": ("bits1", "nodes1", "valid1", "angle1", "x1", "y1", "oct1"),
        "f2": ("bits2t", "nodes2", "valid2", "angle2", "x2", "y2")},
    ("geometry/fused.py", "fused_process_frame"): {
        "fc": _FRAME_C, "fp": _FRAME_P},
}
PORT_EXTRA_PARAMS = ("device",)


def _jax_params(rel, name):
    fn = next(n for n in _tree(rel).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


@pytest.mark.parametrize("rel, name", sorted(SIGNATURES))
def test_parameter_names_follow_jax(rel, name):
    import inspect

    groups = SIGNATURES[(rel, name)]
    want = _jax_params(rel, name)
    for tup, members in groups.items():
        i = want.index(members[0])
        assert want[i:i + len(members)] == list(members)
        want[i:i + len(members)] = [tup]
    got = [p for p in inspect.signature(
        getattr(_port_module(rel), name)).parameters
        if p not in PORT_EXTRA_PARAMS]
    assert got == want
