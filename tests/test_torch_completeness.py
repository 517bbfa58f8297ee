"""The port is complete name by name: every public name of every module of
the JAX package has a counterpart in its ``ray_tpu_torch`` module, read by
AST without importing either package.

Compared, for each ``ray_tpu/**.py`` that has a ``ray_tpu_torch/``
counterpart (``tests/test_torch_topology.py`` holds the module walk): the
public top-level functions and classes, each public class's public methods
and its ``__init__`` and ``__call__`` (the port's methods include those its
classes inherit from bases found by name anywhere in the port), and the
upper-case module constants. A name counts as present in the port when the
port's module binds it at top level in any way (a definition, an
assignment, an import). What stays missing is either ``RENAMED`` (the
port's counterpart under another name, which must exist) or ``EXCEPTED``
(with its reason, and a probe that shows JAX has no caller of it).
"""

import ast
import io
import pathlib
import re
import tokenize

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "ray_tpu", ROOT / "ray_tpu_torch"

# JAX's name -> (the port's module, the counterpart's name, why renamed)
RENAMED = {
    "_private/device_objects.py:is_jax_array": (
        "_private/device_objects.py", "is_tensor",
        "the port's device objects are torch tensors and DTensors"),
    "_private/device_objects.py:jax_reduce": (
        "_private/device_objects.py", "tensor_reduce",
        "the pickler's reducer of a device object"),
    "_private/device_objects.py:reduce_jax_array": (
        "_private/device_objects.py", "reduce_tensor",
        "a device object to its wire form"),
    "_private/device_objects.py:rebuild_jax_array": (
        "_private/device_objects.py", "rebuild_tensor",
        "a device object back from its wire form"),
    "ops/attention.py:axis_size": (
        "parallel/mesh.py", "axis_size",
        "JAX's shim for jax.lax.axis_size; the port's ring and Ulysses "
        "attention read the axis off the DeviceMesh"),
    "ops/paged_attention.py:paged_decode_attention_pallas": (
        "ops/paged_attention.py", "paged_decode_attention_kernel",
        "the Pallas kernel's entry is the CUDA kernel's wrapper"),
    "ops/decode_attention.py:ragged_decode_attention_pallas": (
        "ops/decode_attention.py", "ragged_decode_attention_kernel",
        "the Pallas kernel's entry is the CUDA kernel's wrapper"),
    "util/joblib_backend.py:RayTpuBackend": (
        "util/joblib_backend.py", "_backend_class",
        "built when register_ray runs: the card's machine has no joblib, "
        "so the class cannot subclass joblib's at import"),
}

# JAX's name -> (why the port has none, a regex and how often it matches
# the code of JAX's package and JAX's tests, comments and docstrings
# dropped: its definitions only, never a caller)
EXCEPTED = {
    "_private/worker_process.py:ProcessRouter.actor_worker_pid": (
        "no caller in JAX", r"\bactor_worker_pid\b", 1),
    "_private/worker_process.py:ProcessRouter.worker_pid_for_task": (
        "no caller in JAX", r"\bworker_pid_for_task\b", 1),
    "_private/log_monitor.py:reset_session_log_dir": (
        "no caller in JAX", r"\breset_session_log_dir\b", 1),
    "objectplane/tiers.py:process_tiers": (
        "no caller in JAX", r"\bprocess_tiers\b", 1),
    "_private/daemon.py:DaemonService.handle_core_release": (
        "declared, never sent: no caller in JAX (the declaration and the "
        "handler are the two matches)", r"core_release\b", 2),
    "_private/head.py:HEARTBEAT_S": (
        "no reader in JAX", r"\bHEARTBEAT_S\b", 1),
    "_private/cluster.py:INLINE_RESULT": (
        "no reader in JAX: its daemon reads its own INLINE_RESULT, as the "
        "port's does (the two definitions and the daemon's two reads)",
        r"\bINLINE_RESULT\b", 4),
    "_private/node.py:ResourceLedger.notify": (
        "no caller in JAX: no ledger's notify is called",
        r"ledger\.notify\b", 0),
    "_private/fast_lane.py:KIND_GEN_FALLBACK": (
        "legacy: JAX's lane worker never sends it (it ships KIND_GEN_LIST, "
        "as the port's does; tests/test_torch_fast_lane.py's "
        "test_generator_returning_plain_function_runs_once), JAX's drivers "
        "decode it for older workers, and the port has one worker version",
        r"bytes\(\[KIND_GEN_FALLBACK\]\)", 0),
    "_private/memory_monitor.py:USAGE_THRESHOLD": (
        "None in JAX: the monitor reads the memory_usage_threshold flag, "
        "as the port's does", r"\bUSAGE_THRESHOLD = None\b", 1),
    "_private/memory_monitor.py:CHECK_INTERVAL_S": (
        "None in JAX and read nowhere: the monitor reads the "
        "memory_monitor_interval flag, as the port's does",
        r"\bCHECK_INTERVAL_S\b", 1),
    "serve/grpc_proxy.py:SERVICE_NAME": (
        "grpc's service path; the port's second ingress is an rpc.Server "
        "that declares JAX's four method names (checked below)",
        r"\bSERVICE_NAME\b", 3),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _method_names(cls: ast.ClassDef) -> set:
    names = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


def wanted(tree: ast.Module) -> set:
    """JAX's names of a module: "f", "C", "C.m", "CONST"."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _public(node.name):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and (_public(m.name) or m.name in ("__init__",
                                                       "__call__"))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)
                    and t.id.isupper() and _public(t.id)}
    return out


def bindings(tree: ast.Module) -> dict:
    """Every name a module binds at top level (in top-level ``if``,
    ``try`` and ``with`` blocks too) -> its node."""
    names: dict = {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.setdefault(n.id, node)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    names.setdefault((a.asname or a.name).split(".")[0],
                                     node)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                visit(node.body)
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)
                visit(getattr(node, "orelse", []))
                visit(getattr(node, "finalbody", []))
    visit(tree.body)
    return names


def _base_name(base) -> str:
    if isinstance(base, ast.Name):
        return base.id
    return base.attr if isinstance(base, ast.Attribute) else ""


def methods_with_bases(cls: ast.ClassDef, classes: dict) -> set:
    """A class's methods and those of its bases, found by name in
    ``classes`` (name -> every ClassDef of that name)."""
    seen, todo, out = set(), [cls], set()
    while todo:
        c = todo.pop()
        if id(c) in seen:
            continue
        seen.add(id(c))
        out |= _method_names(c)
        for base in c.bases:
            todo += classes.get(_base_name(base), [])
    return out


def missing_names(jax_sources: dict, port_sources: dict) -> set:
    """``"module:name"`` of every name of ``wanted`` in a JAX module that
    its port module (same relative path) lacks; modules are given as
    relative path -> source, and modules without a counterpart skipped."""
    port_trees = {rel: ast.parse(src) for rel, src in port_sources.items()}
    classes: dict = {}
    for tree in port_trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes.setdefault(node.name, []).append(node)
    missing = set()
    for rel, src in jax_sources.items():
        if rel not in port_trees:
            continue
        have = bindings(port_trees[rel])
        for name in wanted(ast.parse(src)):
            cls, _, method = name.partition(".")
            node = have.get(cls)
            if not method:
                if node is None:
                    missing.add(f"{rel}:{name}")
            elif isinstance(node, ast.ClassDef) and \
                    method not in methods_with_bases(node, classes):
                missing.add(f"{rel}:{name}")
    return missing


def _sources(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_text()
            for p in sorted(root.rglob("*.py"))}


@pytest.fixture(scope="module")
def port_sources():
    return _sources(PORT)


@pytest.fixture(scope="module")
def missing(port_sources):
    return missing_names(_sources(JAX), port_sources)


def test_every_public_name_has_a_counterpart(missing):
    """What the port lacks is exactly the renamed and the excepted names:
    a new gap, or an exception that no longer applies, fails here."""
    assert missing == set(RENAMED) | set(EXCEPTED), (
        sorted(missing - set(RENAMED) - set(EXCEPTED)),
        sorted(set(RENAMED) | set(EXCEPTED) - missing))


@pytest.mark.parametrize("name", sorted(RENAMED))
def test_renamed_counterpart_exists(port_sources, name):
    module, counterpart, reason = RENAMED[name]
    assert reason
    assert counterpart in bindings(ast.parse(port_sources[module])), (
        name, module, counterpart)


def _code(path: pathlib.Path) -> str:
    """A file's source with its comments and docstrings blanked."""
    src = path.read_text()
    lines = src.splitlines(keepends=True)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Constant) \
                and isinstance(node.value.value, str):
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = "\n"
    for tok in tokenize.generate_tokens(io.StringIO("".join(lines))
                                        .readline):
        if tok.type == tokenize.COMMENT:
            row, col = tok.start
            lines[row - 1] = lines[row - 1][:col] + "\n"
    return "".join(lines)


@pytest.fixture(scope="module")
def jax_code():
    """The code of JAX's package and of JAX's own tests."""
    files = sorted(JAX.rglob("*.py")) + sorted(
        p for p in (ROOT / "tests").glob("test_*.py")
        if not p.name.startswith("test_torch_"))
    return "\n".join(_code(p) for p in files)


@pytest.mark.parametrize("name", sorted(EXCEPTED))
def test_excepted_name_has_no_caller_in_jax(jax_code, name):
    reason, probe, count = EXCEPTED[name]
    assert reason
    assert len(re.findall(probe, jax_code)) == count, (name, probe)


def test_memory_monitor_defaults_read_the_same_flags():
    """JAX's two constants are None: its monitor falls back to the flags,
    whose defaults tests/test_torch_config.py holds equal; the port's
    constructor defaults are None and read the same flags."""
    jax_tree = ast.parse((JAX / "_private/memory_monitor.py").read_text())
    consts = {t.id: n.value.value for n in jax_tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and isinstance(n.value,
                                                        ast.Constant)}
    assert consts["USAGE_THRESHOLD"] is None
    assert consts["CHECK_INTERVAL_S"] is None
    port = (PORT / "_private/memory_monitor.py").read_text()
    monitor = next(n for n in ast.parse(port).body
                   if isinstance(n, ast.ClassDef) and n.name == "MemoryMonitor")
    init = next(n for n in monitor.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    defaults = dict(zip([a.arg for a in init.args.args][-len(
        init.args.defaults):], init.args.defaults))
    assert defaults["threshold"].value is None
    assert defaults["interval_s"].value is None
    assert '_flag("memory_usage_threshold")' in port
    assert '_flag("memory_monitor_interval")' in port


def test_second_ingress_declares_jax_methods():
    """JAX's proxy serves four methods under its grpc service; the port's
    rpc.Server declares the same four names (and its stream's cancel)."""
    jax_tree = ast.parse((JAX / "serve/grpc_proxy.py").read_text())
    handlers = next(n.value for n in ast.walk(jax_tree)
                    if isinstance(n, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "handlers"
                            for t in n.targets))
    jax_methods = {k.value for k in handlers.keys}
    port_tree = ast.parse((PORT / "serve/grpc_proxy.py").read_text())
    declared = {n.args[0].value for n in ast.walk(port_tree)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "declare"}
    assert jax_methods == {"Predict", "PredictStream", "ListApplications",
                           "Healthz"}
    assert declared == jax_methods | {"CancelStream"}


def test_inherited_methods_count():
    """The port's MoEModel inherits ``init`` and ``param_shardings`` from
    LlamaModel, so neither is missing."""
    moe = {"models/moe.py": (PORT / "models/moe.py").read_text(),
           "models/llama.py": (PORT / "models/llama.py").read_text()}
    jax_moe = {"models/moe.py": (JAX / "models/moe.py").read_text()}
    assert {"MoEModel.init", "MoEModel.param_shardings"} <= \
        wanted(ast.parse(jax_moe["models/moe.py"]))
    assert not missing_names(jax_moe, moe)
    assert missing_names(jax_moe, {"models/moe.py": moe["models/moe.py"]}) \
        >= {"models/moe.py:MoEModel.init",
            "models/moe.py:MoEModel.param_shardings"}


def test_the_walk_finds_each_kind_of_gap():
    """A function, a class, a method, ``__init__`` and a constant missing
    from a port module are each reported (a missing class once, not its
    methods too); private names, a constant that is not upper-case and a
    name bound by an import are not."""
    jax_src = ("import os\nLIMIT = 3\nlower = 4\n_HIDDEN = 5\n"
               "def f(): pass\ndef _g(): pass\n"
               "class C:\n    def __init__(self): pass\n"
               "    def m(self): pass\n    def _p(self): pass\n"
               "class D:\n    def __call__(self): pass\n"
               "def h(): pass\n")
    port_src = ("from elsewhere import h\nclass C:\n    pass\n")
    assert missing_names({"m.py": jax_src}, {"m.py": port_src}) == {
        "m.py:LIMIT", "m.py:f", "m.py:C.__init__", "m.py:C.m", "m.py:D"}
    assert missing_names({"m.py": jax_src}, {}) == set()
