"""Rules for the serving hot path and CUDA kernel-wrapper hygiene.

``host-sync-in-hot-path`` guards the engine's one-sync-per-step contract:
the only device->host transfer a steady-state step is allowed is the single
int32-per-row token readback (engine ``_step_*`` docstrings).  Everything
else — ``.item()`` in a loop, a ``.cpu()`` of an intermediate, a
``float()`` on a device scalar, a ``torch.cuda.synchronize()`` — stalls the
host until the card drains its queue and turns a replayed step into a
blocking round-trip.

``cuda-kernel-hygiene`` enforces three kernel-wrapper contracts, the
counterpart of the JAX package's ``pallas-kernel-hygiene``:

  * a function that launches a kernel (``lib = _build.load(...)``, then a
    call on ``lib``) checks its operands before the launch: a ``check_*``
    call, or an ``if ...: raise`` on shape, dtype, device or contiguity.
    A ctypes launch takes raw device pointers, so a CPU tensor, a wrong
    dtype or a strided view becomes an illegal address that poisons the
    CUDA context instead of a readable error;
  * dispatch by device (an ``if`` on ``.device.type``, ``.is_cuda`` or
    ``torch.cuda.is_available()`` whose body does not raise) belongs to
    ``kernels/ops.py::_on_cuda``: a kernel module neither picks the plain
    version nor the kernel by itself (``_build.py`` and ``autotune.py``
    are exempt, as the reference exempts ``dispatch.py`` and
    ``autotune.py``);
  * no ``try`` around a launch whose handler runs a plain version: a
    kernel that cannot take its input raises, it never falls back.

The reference's kernel-body check (a Python branch on traced values) has
no counterpart: the port's kernel bodies are CUDA C++ under ``csrc/``,
which this analyzer does not read.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set

from repro_torch.analysis.core import (
    Finding,
    SourceFile,
    assigned_names,
    dotted_name,
    rule,
    stmt_scan_roots,
    walk_statements,
)

# ------------------------------------------------- host-sync-in-hot-path ----
#: per-step engine functions: between step() entry and return, device->host
#: sync is budgeted at exactly one token readback (inline-suppressed at the
#: sanctioned line)
HOT_FN_RE = re.compile(
    r"^(_step_\w+|_ragged_exec|_decode_batch|_prefill_request|_warm_ragged)$")

#: calls that force a device->host transfer when fed a device value
_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
#: calls that block the host on the device whatever they are given
_BLOCKING_CALLS = {"torch.cuda.synchronize"}
#: tensor methods whose result is a host value (and whose call is a sync)
_SYNC_METHODS = {"cpu", "numpy", "item", "tolist"}
_CAST_BUILTINS = {"float", "int", "bool"}


def _is_to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
    "cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and dotted_name(a.func) == "torch.device" \
                and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def _is_sync_method(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and (
        (isinstance(node.func, ast.Attribute)
         and node.func.attr in _SYNC_METHODS) or _is_to_cpu(node))


def _rhs_is_hostlike(node: ast.AST, host: Set[str]) -> bool:
    """Does this RHS produce a host value (literal, np constructor, clock,
    len/int/float of host things, the result of a ``.cpu()``)?"""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.Tuple,
                         ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        if _is_sync_method(node):
            return True
        name = dotted_name(node.func)
        if name.startswith(("np.", "numpy.", "time.")):
            return True
        if name in ("len", "int", "float", "bool", "range", "sorted",
                    "list", "dict", "set", "tuple", "sum", "min", "max",
                    "self.clock", "self.trace.now"):
            return True
        return False
    if isinstance(node, (ast.Name, ast.Attribute)):
        name = dotted_name(node)
        return name in host
    if isinstance(node, ast.Subscript):
        return _rhs_is_hostlike(node.value, host)
    if isinstance(node, ast.BinOp):
        return _rhs_is_hostlike(node.left, host) \
            and _rhs_is_hostlike(node.right, host)
    return False


@rule("host-sync-in-hot-path",
      "device->host transfer (.cpu() / .item() / np.asarray / float() / "
      "torch.cuda.synchronize()) inside a per-step engine function outside "
      "the sanctioned token readback")
def check_host_sync(sf: SourceFile) -> Iterable[Finding]:
    tree = sf.tree
    assert tree is not None
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not HOT_FN_RE.match(fn.name):
            continue
        yield from _check_hot_fn(sf, fn)


def _sync_message(node: ast.Call, host: Set[str], fn_name: str
                  ) -> Optional[str]:
    name = dotted_name(node.func)
    where = f"inside hot-path '{fn_name}'"
    if name in _BLOCKING_CALLS:
        return (f"{name}() {where} blocks the host until the device "
                f"drains its queue")
    if name in _SYNC_CALLS:
        arg = node.args[0] if node.args else None
        if arg is not None and not _rhs_is_hostlike(arg, host):
            return (f"{name}() on a device value {where} forces a blocking "
                    f"device->host transfer")
        return None
    if _is_sync_method(node) and not _rhs_is_hostlike(node.func.value,
                                                      host):
        what = "to('cpu')" if node.func.attr == "to" else node.func.attr
        return (f".{what}() on a device value {where} forces a blocking "
                f"device->host transfer")
    if name in _CAST_BUILTINS and node.args:
        arg = node.args[0]
        if isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript)) \
                and not _rhs_is_hostlike(arg, host):
            return (f"{name}() on a device value {where} is a hidden "
                    f"device->host sync")
    return None


def _check_hot_fn(sf: SourceFile, fn: ast.AST) -> Iterable[Finding]:
    host: Set[str] = set()          # names known to hold host values
    fn_name = getattr(fn, "name", "?")
    for stmt in walk_statements(getattr(fn, "body", [])):
        flagged_targets = False
        for root in stmt_scan_roots(stmt):
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                msg = _sync_message(node, host, fn_name)
                if msg:
                    yield Finding(rule="host-sync-in-hot-path", path=sf.rel,
                                  line=node.lineno, col=node.col_offset,
                                  message=msg)
                    flagged_targets = True
        # propagate hostness: a sync result IS host afterwards (so the
        # engine's sanctioned `nxt = np.asarray(nxt.cpu())` poisons nothing
        # downstream), and host producers stay host
        targets = assigned_names(stmt)
        if targets:
            value = getattr(stmt, "value", None)
            if flagged_targets or (
                    value is not None and _rhs_is_hostlike(value, host)):
                host.update(targets)
            else:
                host.difference_update(targets)


# ------------------------------------------------- cuda-kernel-hygiene ----
#: an operand check by call: ``check_w4a4_operands``, ``_check_cuda``, ...
_CHECK_FN_RE = re.compile(r"^_?check_")
#: attributes an operand check reads
_OPERAND_ATTRS = {"shape", "dtype", "device", "type", "is_cuda",
                  "is_contiguous", "ndim", "numel", "data_ptr", "size",
                  "stride"}
#: the device tests that make an ``if`` a dispatch by device
_DEVICE_CALLS = {"torch.cuda.is_available"}
#: modules that may decide by device: the dispatcher, the build (it finds
#: nvcc) and the tuner (its timer)
_DISPATCH_HOMES = ("ops.py", "_build.py", "autotune.py", "__init__.py")


def _kernel_file(sf: SourceFile) -> bool:
    parts = sf.rel.split("/")
    return "kernels" in parts[:-1] and parts[-1] not in _DISPATCH_HOMES


def _owned_nodes(fn: ast.AST) -> List[ast.AST]:
    """The nodes of ``fn`` outside its nested defs and lambdas."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _is_build_load(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name == "_build.load" or name.endswith("._build.load")


def _launches(fn: ast.AST) -> List[ast.Call]:
    """Calls on a library that ``fn`` loaded with ``_build.load``: through
    the name it bound, or on the load itself."""
    nodes = _owned_nodes(fn)
    libs: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.Assign) and _is_build_load(node.value):
            libs.update(t.id for t in node.targets if isinstance(t, ast.Name))

    def on_lib(lib: ast.AST) -> bool:
        return _is_build_load(lib) or (isinstance(lib, ast.Name)
                                       and lib.id in libs)
    return sorted((node for node in nodes
                   if isinstance(node, ast.Call)
                   and isinstance(node.func, ast.Attribute)
                   and on_lib(node.func.value)),
                  key=lambda c: (c.lineno, c.col_offset))


def _raises(body: List[ast.stmt]) -> bool:
    return any(isinstance(s, ast.Raise) for s in body)


def _names_in(node: ast.AST) -> Set[str]:
    return {sub.id for sub in ast.walk(node) if isinstance(sub, ast.Name)}


def _operands(fn: ast.AST, launch: ast.Call) -> Set[str]:
    """The names whose values reach ``launch``'s arguments: those it
    passes (``_build.ptr(a)``, ``a.numel()``), and, through the
    assignments of ``fn``, the names those were computed from."""
    names: Set[str] = set()
    for arg in list(launch.args) + [kw.value for kw in launch.keywords]:
        names |= _names_in(arg)
    assigns = [node for node in _owned_nodes(fn)
               if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign))
               and node.value is not None]
    grew = True
    while grew:
        grew = False
        for node in assigns:
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(_names_in(t) & names for t in targets):
                more = _names_in(node.value) - names
                if more:
                    names |= more
                    grew = True
    return names


def _reads_operand_attr(test: ast.AST, operands: Set[str]) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and sub.attr in _OPERAND_ATTRS \
                and _names_in(sub.value) & operands:
            return True
        if isinstance(sub, ast.Call) and dotted_name(sub.func) == "len" \
                and any(_names_in(a) & operands for a in sub.args):
            return True
    return False


def _checks_before(fn: ast.AST, launch: ast.Call) -> bool:
    """A ``check_*`` call given one of the launch's operands, or an ``if``
    on an operand's shape / dtype / device / contiguity that raises,
    before the launch.  A check of anything else (a strategy name, a
    flag) is not an operand check."""
    line = launch.lineno
    operands = _operands(fn, launch)
    for node in _owned_nodes(fn):
        if getattr(node, "lineno", line) >= line:
            continue
        if isinstance(node, ast.Call):
            last = dotted_name(node.func).split(".")[-1]
            args = list(node.args) + [kw.value for kw in node.keywords]
            if _CHECK_FN_RE.match(last) \
                    and any(_names_in(a) & operands for a in args):
                return True
        if isinstance(node, ast.If) and _raises(node.body) \
                and _reads_operand_attr(node.test, operands):
            return True
    return False


def _device_test(test: ast.AST) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and sub.attr == "is_cuda":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "type" \
                and isinstance(sub.value, ast.Attribute) \
                and sub.value.attr == "device":
            return True
        if isinstance(sub, ast.Call) \
                and dotted_name(sub.func) in _DEVICE_CALLS:
            return True
    return False


def _runs_launch(node: ast.AST) -> bool:
    """A launch or a CUDA wrapper's call anywhere under ``node``."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = dotted_name(sub.func)
        if _is_build_load(sub) or name.endswith("_cuda"):
            return True
    return False


def _calls_plain(body: List[ast.stmt]) -> bool:
    return any(isinstance(sub, ast.Call)
               and dotted_name(sub.func).endswith("_plain")
               for stmt in body for sub in ast.walk(stmt))


@rule("cuda-kernel-hygiene",
      "kernel launches without an operand check, dispatch by device "
      "outside kernels/ops.py, and a try around a launch that falls back "
      "to a plain version")
def check_cuda_hygiene(sf: SourceFile) -> Iterable[Finding]:
    tree = sf.tree
    assert tree is not None
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        launches = _launches(fn)
        if launches and not _checks_before(fn, launches[0]):
            call = launches[0]
            yield Finding(
                rule="cuda-kernel-hygiene", path=sf.rel,
                line=call.lineno, col=call.col_offset,
                message=f"'{fn.name}' launches a kernel with no operand "
                        f"check before it (a check_* call or an `if ...: "
                        f"raise` on shape/dtype/device/contiguity): a "
                        f"ctypes launch takes raw pointers, so a bad "
                        f"operand poisons the CUDA context")

    if _kernel_file(sf):
        for node in ast.walk(tree):
            if isinstance(node, ast.If) and _device_test(node.test) \
                    and not _raises(node.body):
                yield Finding(
                    rule="cuda-kernel-hygiene", path=sf.rel,
                    line=node.lineno, col=node.col_offset,
                    message="dispatch by device inside a kernel module: "
                            "kernels/ops.py::_on_cuda picks the plain "
                            "version or the kernel in one place (a device "
                            "test here must raise)")
            elif isinstance(node, ast.IfExp) and _device_test(node.test):
                yield Finding(
                    rule="cuda-kernel-hygiene", path=sf.rel,
                    line=node.lineno, col=node.col_offset,
                    message="dispatch by device inside a kernel module: "
                            "kernels/ops.py::_on_cuda picks the plain "
                            "version or the kernel in one place")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        if not any(_runs_launch(stmt) for stmt in node.body):
            continue
        for handler in node.handlers:
            if _calls_plain(handler.body):
                yield Finding(
                    rule="cuda-kernel-hygiene", path=sf.rel,
                    line=handler.lineno, col=handler.col_offset,
                    message="a failed launch falls back to the plain "
                            "version: a kernel that cannot take its input "
                            "raises, it never falls back (dispatch "
                            "follows the tensor's device alone)")
