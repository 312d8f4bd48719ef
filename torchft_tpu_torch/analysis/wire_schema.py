"""Wire-schema extractor + drift lint (tft-verify leg 2, pass id
``wire-drift``).

The framed-JSON coordination protocol is implemented three times: the
Python clients (``torchft_tpu_torch/coordination.py``), the native servers
(``native/lighthouse.cc`` / ``manager.cc`` / ``store.cc``), and the prose
in ``docs/protocol.md``.  Nothing kept them in sync until now — a field
renamed on one side silently degrades to its wire default on the other
(every ``from_dict``/``Json::get`` read is total), which is exactly the
failure mode that never shows up in unit tests.

This pass extracts each side into one canonical schema:

* **Python** — ``ast`` over the client classes: every
  ``self._client.call("method", {...})`` site yields the method's param
  names + types (from dict literals, ``params["k"] = v`` build-up, and
  the enclosing signature's annotations); ``result["k"]`` subscripts and
  ``Struct.from_dict(result)`` yield the result fields the client relies
  on; ``to_dict``/``from_dict`` dataclasses yield the shared structs.
* **Native** — a dispatch-aware scan of the ``.cc`` sources: each
  ``method == "name"`` arm is resolved to its handler body (brace
  matching), where ``params.get("k").as_T()`` reads give params + types
  and ``out["k"] = ...`` writes give result fields;
  ``Struct::to_json``/``from_json`` give the native struct surface; the
  native manager's own lighthouse calls (``client.call("m", params)``)
  are checked as a third client.
* **Docs** — the "Wire surface" table in ``docs/protocol.md`` must carry
  one ``| server | method |`` row per method.

The merged schema is written to ``torchft_tpu_torch/analysis/protocol.lock``
(committed, shipped as package data) by ``tft-verify --write-lock``; the
lint then reports missing/dead/mistyped fields, undocumented methods,
and any divergence between the tree and the committed lock.
``tests/test_torch_wire_schema.py`` generates round-trip conformance tests
from the lock file and seeds a drift on every side to prove the gate
bites.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Any, Dict, Iterable, Iterator, List, Optional, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding, LintPass, Project, SelftestError

__all__ = [
    "PASS",
    "LOCK_VERSION",
    "WIRE_FRAMING",
    "extract_python",
    "extract_native",
    "build_lock",
    "lock_path",
    "load_lock",
    "run_checks",
]

PASS_ID = "wire-drift"

LOCK_VERSION = 1

#: One-line framing contract, embedded in the lock so a framing change is
#: itself a lock drift (coordination.py module docstring + native/net.h).
WIRE_FRAMING = (
    "4-byte big-endian length + UTF-8 JSON; request "
    '{"method","params","timeout_ms","traceparent"?}; reply '
    '{"ok","result"} | {"ok","error","code"?}; max frame 512 MiB'
)

#: canonical wire types
_TYPES = ("string", "int", "bool", "double", "object", "array", "any")

#: Python client class -> server name it speaks to
_CLIENT_SERVERS = {
    "LighthouseClient": "lighthouse",
    "ManagerClient": "manager",
    "StoreClient": "store",
}

#: native source file -> server whose dispatch it holds
_NATIVE_SERVERS = {
    "lighthouse.cc": "lighthouse",
    "manager.cc": "manager",
    "store.cc": "store",
}

#: shared struct names (Python dataclasses with to_dict/from_dict,
#: native StructName::to_json/from_json)
_STRUCTS = ("QuorumMember", "Quorum", "QuorumResult")


# ---------------------------------------------------------------------------
# schema model (plain dicts so the lock is trivially JSON)
# ---------------------------------------------------------------------------
#
# servers: {server: {method: {"params": {name: type}, "result": [name],
#                             "result_struct": str|None}}}
# structs: {name: {field: type}}

Schema = Dict[str, Any]


def _empty_schema() -> Schema:
    return {"servers": {}, "structs": {}}


def _method(schema: Schema, server: str, method: str) -> Dict[str, Any]:
    srv = schema["servers"].setdefault(server, {})
    return srv.setdefault(
        method, {"params": {}, "result": [], "result_struct": None}
    )


# ---------------------------------------------------------------------------
# Python extraction
# ---------------------------------------------------------------------------


def _canon_annotation(text: str) -> str:
    """Canonical wire type for a Python annotation (best effort)."""
    t = text.strip().strip("\"'")
    # containers first: List[int] is an array, not an int
    if re.search(r"\b(Dict|dict|Mapping)\b", t):
        return "object"
    if re.search(r"\b(List|list|Sequence|Tuple|tuple)\b", t):
        return "array"
    if re.search(r"\bbool\b", t):
        return "bool"
    if re.search(r"\bint\b", t):
        return "int"
    if re.search(r"\bfloat\b", t):
        return "double"
    if re.search(r"\bstr\b", t):
        return "string"
    return "any"


def _annotation_text(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.10+
        return ""


def _value_type(node: ast.AST, arg_types: Dict[str, str]) -> str:
    """Canonical wire type of a param-value expression."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool):
            return "bool"
        if isinstance(node.value, int):
            return "int"
        if isinstance(node.value, float):
            return "double"
        if isinstance(node.value, str):
            return "string"
        return "any"
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):
            return {
                "int": "int",
                "bool": "bool",
                "float": "double",
                "str": "string",
                "dict": "object",
                "list": "array",
            }.get(fn.id, "any")
        if isinstance(fn, ast.Attribute):
            if fn.attr == "to_dict":
                return "object"
            if fn.attr == "dumps":
                return "string"
        return "any"
    if isinstance(node, ast.Name):
        return arg_types.get(node.id, "any")
    if isinstance(node, ast.Dict):
        return "object"
    if isinstance(node, (ast.List, ast.ListComp)):
        return "array"
    return "any"


def _is_rpc_call(node: ast.Call) -> bool:
    """``<something>.call("method", params, ...)`` with a literal method."""
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "call"
        and len(node.args) >= 2
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
    )


def extract_python(source: str, filename: str = "coordination.py") -> Schema:
    """Schema seen by the Python clients in ``source``."""
    schema = _empty_schema()
    tree = ast.parse(source, filename=filename)

    for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
        if cls.name in _STRUCTS:
            _extract_py_struct(schema, cls)
        server = _CLIENT_SERVERS.get(cls.name)
        if server is None:
            continue
        for fn in [
            n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]:
            _extract_py_client_method(schema, server, fn)
    return schema


def _extract_py_struct(schema: Schema, cls: ast.ClassDef) -> None:
    fields: Dict[str, str] = {}
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            fields[node.target.id] = _canon_annotation(
                _annotation_text(node.annotation)
            )
    # cross-check the wire accessors against the annotations: a field in
    # to_dict/from_dict but not the dataclass (or vice versa) is drift
    # INSIDE the Python side; surfaced via the merged field set.
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                fields.setdefault(node.args[0].value, "any")
        if isinstance(node, ast.Dict):
            for key in node.keys:
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    fields.setdefault(key.value, "any")
    schema["structs"][cls.name] = fields


def _extract_py_client_method(
    schema: Schema, server: str, fn: ast.AST
) -> None:
    assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    arg_types = {
        a.arg: _canon_annotation(_annotation_text(a.annotation))
        for a in list(fn.args.args) + list(fn.args.kwonlyargs)
    }
    # params["k"] = v build-up (one shared `params` dict per method here)
    built: Dict[str, str] = {}
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Subscript)
            and isinstance(node.targets[0].slice, ast.Constant)
            and isinstance(node.targets[0].slice.value, str)
        ):
            built[node.targets[0].slice.value] = _value_type(
                node.value, arg_types
            )
    # the RPC call sites
    result_vars: Dict[str, str] = {}  # var name -> method
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            if _is_rpc_call(call) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name
            ):
                result_vars[node.targets[0].id] = call.args[0].value  # type: ignore[union-attr]
        if not (isinstance(node, ast.Call) and _is_rpc_call(node)):
            continue
        method_name = node.args[0].value  # type: ignore[union-attr]
        assert isinstance(method_name, str)
        m = _method(schema, server, method_name)
        params_arg = node.args[1]
        if isinstance(params_arg, ast.Dict):
            for key, val in zip(params_arg.keys, params_arg.values):
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    m["params"].setdefault(
                        key.value, _value_type(val, arg_types)
                    )
        elif isinstance(params_arg, ast.Name):
            for k, t in built.items():
                m["params"].setdefault(k, t)
            # seed-literal dict the name was initialized from (plain or
            # annotated assignment — ``params: Dict[...] = {...}``)
            for sub in ast.walk(fn):
                tgt: Optional[ast.expr] = None
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                elif isinstance(sub, ast.AnnAssign):
                    tgt = sub.target
                if (
                    tgt is not None
                    and isinstance(tgt, ast.Name)
                    and tgt.id == params_arg.id
                    and isinstance(sub.value, ast.Dict)
                ):
                    for key, val in zip(sub.value.keys, sub.value.values):
                        if isinstance(key, ast.Constant) and isinstance(
                            key.value, str
                        ):
                            m["params"].setdefault(
                                key.value, _value_type(val, arg_types)
                            )
    # result field reads: result["k"] subscripts and Struct.from_dict(result)
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
        ):
            base = node.value
            if isinstance(base, ast.Name) and base.id in result_vars:
                m = _method(schema, server, result_vars[base.id])
                if node.slice.value not in m["result"]:
                    m["result"].append(node.slice.value)
            elif isinstance(base, ast.Call) and _is_rpc_call(base):
                m = _method(schema, server, base.args[0].value)  # type: ignore[arg-type]
                if node.slice.value not in m["result"]:
                    m["result"].append(node.slice.value)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "from_dict"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in _STRUCTS
            and node.args
            and isinstance(node.args[0], ast.Name)
            and node.args[0].id in result_vars
        ):
            m = _method(schema, server, result_vars[node.args[0].id])
            m["result_struct"] = node.func.value.id


def extract_py_envelope(source: str) -> "Set[str]":
    """Request-envelope fields the Python ``_RpcClient`` sends: string
    keys of dict literals passed to ``json.dumps`` inside
    ``_RpcClient.call`` plus ``<var>["k"] = ...`` build-up there.  Empty
    when the source has no ``_RpcClient`` (mini projects)."""
    fields: "Set[str]" = set()
    tree = ast.parse(source)
    for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
        if cls.name != "_RpcClient":
            continue
        for fn in ast.walk(cls):
            if not (
                isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name == "call"
            ):
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "dumps"
                    and node.args
                ):
                    arg = node.args[0]
                    if isinstance(arg, ast.Dict):
                        for key in arg.keys:
                            if isinstance(key, ast.Constant) and isinstance(
                                key.value, str
                            ):
                                fields.add(key.value)
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Subscript)
                    and isinstance(node.targets[0].slice, ast.Constant)
                    and isinstance(node.targets[0].slice.value, str)
                ):
                    fields.add(node.targets[0].slice.value)
                # seed dict of the variable later dumped (req = {...})
                if (
                    isinstance(node, ast.AnnAssign)
                    and isinstance(node.value, ast.Dict)
                ) or (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Dict)
                ):
                    for key in node.value.keys:
                        if isinstance(key, ast.Constant) and isinstance(
                            key.value, str
                        ):
                            fields.add(key.value)
    return fields


_ENVELOPE_READ_RE = re.compile(r'\breq\.get\("(\w+)"\)')
_ENVELOPE_WRITE_RE = re.compile(r'\breq\["(\w+)"\]\s*=')


def extract_native_envelope(
    sources: Dict[str, str]
) -> "Tuple[Set[str], Set[str]]":
    """(reads, writes) of the request envelope on the native side:
    ``req.get("k")`` in the server's ``serve_conn`` and ``req["k"] =``
    in the clients (``RpcClient::call`` / ``call_rpc``) — all in
    net.cc, where the one framed-envelope implementation lives."""
    reads: "Set[str]" = set()
    writes: "Set[str]" = set()
    for fname, text in sources.items():
        if os.path.basename(fname) != "net.cc":
            continue
        body = _function_body(text, "serve_conn")
        for m in _ENVELOPE_READ_RE.finditer(body or text):
            reads.add(m.group(1))
        for m in _ENVELOPE_WRITE_RE.finditer(text):
            writes.add(m.group(1))
    return reads, writes


# ---------------------------------------------------------------------------
# native extraction
# ---------------------------------------------------------------------------

_DISPATCH_RE = re.compile(r'method\s*==\s*"(\w+)"\s*\)')
_PARAM_READ_RE = re.compile(r'params\.get\("([^"]+)"\)(?:\.(as_\w+)\()?')
_RESULT_WRITE_RE = re.compile(r'\bout\["([^"]+)"\]\s*=')
_RETURN_STRUCT_RE = re.compile(r"\breturn\s+(\w+)\.to_json\(\)")
_CLIENT_CALL_RE = re.compile(r'\.call\("(\w+)",\s*(\w+)')

_AS_TYPES = {
    "as_string": "string",
    "as_int": "int",
    "as_bool": "bool",
    "as_double": "double",
    "as_array": "array",
    "as_object": "object",
}


def _match_braces(text: str, open_idx: int) -> int:
    """Index one past the brace block opening at ``open_idx`` ('{')."""
    depth = 0
    i = open_idx
    while i < len(text):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        elif c == '"':  # skip string literals
            i += 1
            while i < len(text) and text[i] != '"':
                i += 2 if text[i] == "\\" else 1
        i += 1
    return len(text)


def _function_body(text: str, name: str) -> str:
    """Body of the member/function definition ``...::name(...) {...}``
    ('' when not found). Skips prototypes (no ``{`` before ``;``)."""
    for m in re.finditer(r"::" + re.escape(name) + r"\s*\(", text):
        i = m.end()
        depth = 1
        while i < len(text) and depth:  # skip the parameter list
            depth += text[i] == "("
            depth -= text[i] == ")"
            i += 1
        j = i
        while j < len(text) and text[j] not in "{;":
            j += 1
        if j < len(text) and text[j] == "{":
            return text[j:_match_braces(text, j)]
    return ""


def _dispatch_arm(text: str, idx: int) -> str:
    """The statement/block guarded by the ``method == "..."`` test at
    ``idx``: a brace block, or the single statement up to ``;``."""
    i = idx
    while i < len(text) and text[i] not in "{;":
        i += 1
    if i < len(text) and text[i] == "{":
        return text[i:_match_braces(text, i)]
    return text[idx : i + 1]


def _collect_handler(schema: Schema, server: str, method: str, body: str) -> None:
    m = _method(schema, server, method)
    for pm in _PARAM_READ_RE.finditer(body):
        name, as_t = pm.group(1), pm.group(2)
        m["params"].setdefault(
            name, _AS_TYPES.get(as_t or "", "object" if not as_t else "any")
        )
    for rm in _RESULT_WRITE_RE.finditer(body):
        if rm.group(1) not in m["result"]:
            m["result"].append(rm.group(1))
    rs = _RETURN_STRUCT_RE.search(body)
    if rs is not None:
        var = rs.group(1)
        decl = re.search(r"\b(\w+)\s+" + re.escape(var) + r"\s*[;({=]", body)
        if decl is not None and decl.group(1) in _STRUCTS:
            m["result_struct"] = decl.group(1)


def extract_native(sources: Dict[str, str]) -> Tuple[Schema, Schema]:
    """(server schema, client schema) from ``{filename: text}`` native
    sources.  The client schema records params the native code SENDS
    (e.g. the manager's heartbeat piggyback to the lighthouse), keyed by
    method name under server ``"?"`` — resolved against the lock by the
    checks, not here."""
    schema = _empty_schema()
    client = _empty_schema()
    for fname, text in sources.items():
        server = _NATIVE_SERVERS.get(os.path.basename(fname))
        if server is not None:
            for dm in _DISPATCH_RE.finditer(text):
                method = dm.group(1)
                arm = _dispatch_arm(text, dm.end())
                # params read inline in the dispatch statement itself
                _collect_handler(schema, server, method, arm)
                ret = re.search(r"\breturn\s+(\w+)\s*\(", arm)
                if ret is not None and not arm.lstrip().startswith("{"):
                    body = _function_body(text, ret.group(1))
                    if body:
                        _collect_handler(schema, server, method, body)
        # struct to_json / from_json surfaces (member fns; scoped per struct)
        for struct in _STRUCTS:
            fields = schema["structs"].setdefault(struct, {})
            for m in re.finditer(
                re.escape(struct) + r"::to_json\s*\(", text
            ):
                brace = text.find("{", m.end())
                if brace < 0:
                    continue
                body = text[brace : _match_braces(text, brace)]
                for w in re.finditer(r'\bj\["([^"]+)"\]\s*=', body):
                    fields.setdefault(w.group(1), "any")
            for m in re.finditer(
                re.escape(struct) + r"::from_json\s*\(", text
            ):
                brace = text.find("{", m.end())
                if brace < 0:
                    continue
                body = text[brace : _match_braces(text, brace)]
                for r in re.finditer(
                    r'\bj\.get\("([^"]+)"\)(?:\.(as_\w+)\()?', body
                ):
                    t = _AS_TYPES.get(r.group(2) or "", "any")
                    prev = fields.get(r.group(1))
                    fields[r.group(1)] = t if prev in (None, "any") else prev
        # native client call sites: ``<x>.call("method", <var>...)`` with
        # ``<var>["k"] = ...`` builds, scoped to the ENCLOSING top-level
        # function (the previous column-0 closing brace bounds it — a
        # wider window would blame one RPC for a sibling's params)
        for cm in _CLIENT_CALL_RE.finditer(text):
            method, var = cm.group(1), cm.group(2)
            start = text.rfind("\n}", 0, cm.start())
            window = text[max(start, 0) : cm.start()]
            mm = _method(client, "?", method)
            for pw in re.finditer(
                r"\b" + re.escape(var) + r'\["([^"]+)"\]\s*=', window
            ):
                mm["params"].setdefault(pw.group(1), "any")
    # drop empty struct entries for files that never define them
    schema["structs"] = {
        k: v for k, v in schema["structs"].items() if v
    }
    return schema, client


# ---------------------------------------------------------------------------
# lock build / load
# ---------------------------------------------------------------------------


def _merge_types(native_t: str, py_t: str) -> str:
    if native_t != "any":
        return native_t
    return py_t


def build_lock(
    py_source: str, native_sources: Dict[str, str]
) -> Dict[str, Any]:
    """The canonical lock document: native truth merged with Python types
    where the native side is untyped."""
    py = extract_python(py_source)
    native, _client = extract_native(native_sources)
    servers: Dict[str, Any] = {}
    for server in sorted(
        set(native["servers"]) | set(py["servers"])
    ):
        nsrv = native["servers"].get(server, {})
        psrv = py["servers"].get(server, {})
        methods: Dict[str, Any] = {}
        for method in sorted(set(nsrv) | set(psrv)):
            nm = nsrv.get(method, {"params": {}, "result": [], "result_struct": None})
            pm = psrv.get(method, {"params": {}, "result": [], "result_struct": None})
            params = {
                k: _merge_types(
                    nm["params"].get(k, "any"), pm["params"].get(k, "any")
                )
                for k in sorted(set(nm["params"]) | set(pm["params"]))
            }
            methods[method] = {
                "params": params,
                "result": sorted(set(nm["result"]) | set(pm["result"])),
                "result_struct": nm["result_struct"] or pm["result_struct"],
            }
        servers[server] = methods
    structs: Dict[str, Any] = {}
    for name in sorted(set(native["structs"]) | set(py["structs"])):
        nf = native["structs"].get(name, {})
        pf = py["structs"].get(name, {})
        structs[name] = {
            k: _merge_types(nf.get(k, "any"), pf.get(k, "any"))
            for k in sorted(set(nf) | set(pf))
        }
    # request-envelope surface (method/params/timeout_ms + the tracing
    # traceparent field): union of what the Python client sends and the
    # native server reads — per-side drift is flagged by run_checks.
    py_env = extract_py_envelope(py_source)
    n_reads, n_writes = extract_native_envelope(native_sources)
    return {
        "version": LOCK_VERSION,
        "framing": WIRE_FRAMING,
        "envelope": sorted(py_env | n_reads | n_writes),
        "servers": servers,
        "structs": structs,
    }


def lock_path(coordination_py: str) -> str:
    """Committed lock location: ``analysis/protocol.lock`` next to the
    package's ``coordination.py``."""
    return os.path.join(
        os.path.dirname(os.path.abspath(coordination_py)),
        "analysis",
        "protocol.lock",
    )


def default_lock_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "protocol.lock"
    )


def load_lock(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    assert isinstance(doc, dict)
    return doc


def dump_lock(lock: Dict[str, Any]) -> str:
    return json.dumps(lock, indent=2, sort_keys=True) + "\n"


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _doc_row_re(server: str, method: str) -> "re.Pattern[str]":
    return re.compile(
        r"\|\s*" + re.escape(server) + r"\s*\|\s*`?" + re.escape(method) + r"`?\s*\|"
    )


def run_checks(
    py_source: str,
    native_sources: Dict[str, str],
    docs_text: str,
    committed_lock: Optional[Dict[str, Any]],
    py_file: str = "torchft_tpu_torch/coordination.py",
    native_file_of: Optional[Dict[str, str]] = None,
    docs_file: str = "docs/protocol.md",
    lock_file: str = "torchft_tpu_torch/analysis/protocol.lock",
) -> Iterator[Finding]:
    """All drift findings between the four surfaces."""
    native_file_of = native_file_of or {}

    def finding(code: str, file: str, message: str, symbol: str = "") -> Finding:
        return Finding(
            pass_id=PASS_ID,
            code=code,
            file=file,
            line=0,
            message=message,
            symbol=symbol,
        )

    py = extract_python(py_source)
    native, nclient = extract_native(native_sources)
    fresh = build_lock(py_source, native_sources)

    def nfile(server: str) -> str:
        for base, srv in _NATIVE_SERVERS.items():
            if srv == server and base in native_file_of:
                return native_file_of[base]
        return "native/"

    # ---- methods exist on both sides ------------------------------------
    for server, psrv in py["servers"].items():
        nsrv = native["servers"].get(server, {})
        for method in psrv:
            if method not in nsrv:
                yield finding(
                    "method-missing-native",
                    nfile(server),
                    f"Python client calls {server}.{method} but no native "
                    f"dispatch arm serves it",
                    f"{server}.{method}",
                )
    for server, nsrv in native["servers"].items():
        psrv = py["servers"].get(server, {})
        for method in nsrv:
            if method not in psrv:
                yield finding(
                    "method-dead-native",
                    py_file,
                    f"native {server} serves method {method!r} that no "
                    f"Python client calls (dead method, or a missing client "
                    f"binding)",
                    f"{server}.{method}",
                )

    # ---- per-method params + result ------------------------------------
    for server, psrv in py["servers"].items():
        nsrv = native["servers"].get(server, {})
        for method, pm in psrv.items():
            nm = nsrv.get(method)
            if nm is None:
                continue
            sym = f"{server}.{method}"
            for k, pt in pm["params"].items():
                if k not in nm["params"]:
                    yield finding(
                        "param-dead",
                        nfile(server),
                        f"{sym} param {k!r} is sent by the Python client "
                        f"but never read by the native handler",
                        f"{sym}.{k}",
                    )
                else:
                    nt = nm["params"][k]
                    if "any" not in (pt, nt) and pt != nt:
                        yield finding(
                            "type-mismatch",
                            py_file,
                            f"{sym} param {k!r}: Python sends {pt}, native "
                            f"reads {nt}",
                            f"{sym}.{k}",
                        )
            for k in nm["params"]:
                if k not in pm["params"]:
                    yield finding(
                        "param-missing",
                        py_file,
                        f"{sym} param {k!r} is read by the native handler "
                        f"but never sent by the Python client",
                        f"{sym}.{k}",
                    )
            for k in pm["result"]:
                if k not in nm["result"] and nm["result_struct"] is None:
                    yield finding(
                        "result-missing",
                        nfile(server),
                        f"{sym}: Python reads result[{k!r}] but the native "
                        f"handler never writes it",
                        f"{sym}.{k}",
                    )
            if (
                pm["result_struct"]
                and nm["result_struct"]
                and pm["result_struct"] != nm["result_struct"]
            ):
                yield finding(
                    "result-struct-mismatch",
                    py_file,
                    f"{sym}: Python parses the result as "
                    f"{pm['result_struct']}, native returns "
                    f"{nm['result_struct']}",
                    sym,
                )

    # ---- native client sends (manager -> lighthouse etc.) ---------------
    all_servers = fresh["servers"]
    for method, mm in nclient["servers"].get("?", {}).items():
        served_by = [s for s, ms in all_servers.items() if method in ms]
        if not served_by:
            yield finding(
                "method-missing-native",
                "native/",
                f"native client calls method {method!r} that no server "
                f"dispatches",
                method,
            )
            continue
        ok = any(
            set(mm["params"]) <= set(all_servers[s][method]["params"])
            for s in served_by
        )
        if not ok:
            extras = sorted(
                set(mm["params"])
                - set.union(
                    *(set(all_servers[s][method]["params"]) for s in served_by)
                )
            )
            yield finding(
                "param-dead",
                "native/",
                f"native client sends {method} param(s) {extras} that no "
                f"server handler reads",
                method,
            )

    # ---- structs ---------------------------------------------------------
    for name in sorted(set(py["structs"]) | set(native["structs"])):
        pf = py["structs"].get(name)
        nf = native["structs"].get(name)
        if pf is None or nf is None:
            continue  # struct only exists on one side (e.g. no native parse)
        for k, pt in pf.items():
            if k not in nf:
                yield finding(
                    "struct-field-missing",
                    nfile("lighthouse"),
                    f"struct {name} field {k!r} exists in Python but not in "
                    f"the native to_json/from_json surface",
                    f"{name}.{k}",
                )
            else:
                nt = nf[k]
                if "any" not in (pt, nt) and pt != nt:
                    yield finding(
                        "type-mismatch",
                        py_file,
                        f"struct {name} field {k!r}: Python {pt}, native {nt}",
                        f"{name}.{k}",
                    )
        for k in nf:
            if k not in pf:
                yield finding(
                    "struct-field-missing",
                    py_file,
                    f"struct {name} field {k!r} exists natively but not in "
                    f"the Python dataclass surface",
                    f"{name}.{k}",
                )

    # ---- request envelope (method/params/timeout_ms/traceparent) --------
    py_env = extract_py_envelope(py_source)
    n_reads, n_writes = extract_native_envelope(native_sources)
    if py_env and n_reads:
        # an empty side means this project form has no envelope surface
        # (mini/selftest trees, wheel installs) — nothing to cross-check
        for field_name in sorted(py_env - n_reads):
            yield finding(
                "envelope-field-dead",
                native_file_of.get("net.cc", "native/net.cc"),
                f"request-envelope field {field_name!r} is sent by the "
                f"Python client but never read by the native server "
                f"(serve_conn)",
                f"envelope.{field_name}",
            )
        for field_name in sorted(n_reads - py_env):
            yield finding(
                "envelope-field-missing",
                py_file,
                f"request-envelope field {field_name!r} is read by the "
                f"native server but never sent by the Python client",
                f"envelope.{field_name}",
            )
        for field_name in sorted(n_writes - n_reads):
            yield finding(
                "envelope-field-dead",
                native_file_of.get("net.cc", "native/net.cc"),
                f"request-envelope field {field_name!r} is written by the "
                f"native client but never read by the native server",
                f"envelope.{field_name}",
            )
        if docs_text:
            for field_name in sorted(py_env | n_reads):
                if not re.search(
                    "[`\"]" + re.escape(field_name) + "[`\"]", docs_text
                ):
                    yield finding(
                        "envelope-undocumented",
                        docs_file,
                        f"request-envelope field {field_name!r} is not "
                        f"documented in {docs_file} (backticked or quoted)",
                        f"envelope.{field_name}",
                    )

    # ---- docs ------------------------------------------------------------
    for server, methods in fresh["servers"].items():
        for method in methods:
            if not _doc_row_re(server, method).search(docs_text):
                yield finding(
                    "method-undocumented",
                    docs_file,
                    f"{server}.{method} has no `| {server} | {method} |` row "
                    f"in the {docs_file} wire-surface table",
                    f"{server}.{method}",
                )

    # ---- committed lock vs tree -----------------------------------------
    if committed_lock is None:
        yield finding(
            "lock-missing",
            lock_file,
            f"{lock_file} is not committed; generate it with "
            f"`tft-verify --write-lock`",
        )
    elif committed_lock != fresh:
        diffs = _lock_diff(committed_lock, fresh)
        for d in diffs[:20]:
            yield finding(
                "lock-drift",
                lock_file,
                f"committed protocol.lock disagrees with the tree: {d} "
                f"(review the change, then `tft-verify --write-lock`)",
                d.split(" ", 1)[0],
            )


def _lock_diff(a: Dict[str, Any], b: Dict[str, Any], prefix: str = "") -> List[str]:
    out: List[str] = []
    keys = sorted(set(a) | set(b))
    for k in keys:
        path = f"{prefix}{k}"
        if k not in a:
            out.append(f"{path} only in tree")
        elif k not in b:
            out.append(f"{path} only in lock")
        elif isinstance(a[k], dict) and isinstance(b[k], dict):
            out.extend(_lock_diff(a[k], b[k], path + "."))
        elif a[k] != b[k]:
            out.append(f"{path}: lock={a[k]!r} tree={b[k]!r}")
    return out


# ---------------------------------------------------------------------------
# LintPass wiring
# ---------------------------------------------------------------------------

_NATIVE_FILES = ("lighthouse.cc", "manager.cc", "store.cc", "capi.cc", "net.cc")


def gather_inputs(
    root: str, coordination_py: Optional[str] = None
) -> Tuple[str, Dict[str, str], Dict[str, str], str, Optional[Dict[str, Any]], str]:
    """(py_source, native_sources, native_file_of, docs_text, lock, lock_file)
    for a tree rooted at ``root``."""
    cpath = coordination_py or os.path.join(root, "torchft_tpu_torch", "coordination.py")
    with open(cpath, encoding="utf-8") as fh:
        py_source = fh.read()
    native_sources: Dict[str, str] = {}
    native_file_of: Dict[str, str] = {}
    ndir = os.path.join(root, "native")
    for base in _NATIVE_FILES:
        path = os.path.join(ndir, base)
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as fh:
                native_sources[base] = fh.read()
            native_file_of[base] = os.path.relpath(path, root)
    docs = os.path.join(root, "docs", "protocol.md")
    docs_text = ""
    if os.path.isfile(docs):
        with open(docs, encoding="utf-8") as fh:
            docs_text = fh.read()
    lpath = lock_path(cpath)
    lock = load_lock(lpath)
    return (
        py_source,
        native_sources,
        native_file_of,
        docs_text,
        lock,
        os.path.relpath(lpath, root),
    )


def _run(project: Project) -> Iterable[Finding]:
    cpath = project.find_file("coordination.py")
    if cpath is None:
        return []
    (
        py_source,
        native_sources,
        native_file_of,
        docs_text,
        lock,
        lock_file,
    ) = gather_inputs(project.root, cpath)
    if not native_sources:
        # a tree without native sources (e.g. a wheel install) has
        # nothing to cross-check; the committed lock is the contract
        return []
    return list(
        run_checks(
            py_source,
            native_sources,
            docs_text,
            lock,
            py_file=project.rel(cpath),
            native_file_of=native_file_of,
            lock_file=lock_file,
        )
    )


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

#: Minimal three-surface project the selftest (and the seeded-drift gate
#: in tests/test_torch_wire_schema.py) materializes and perturbs.
MINI_PY = '''\
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class QuorumMember:
    replica_id: str
    step: int = 0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QuorumMember":
        return QuorumMember(
            replica_id=d.get("replica_id", ""),
            step=d.get("step", 0),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"replica_id": self.replica_id, "step": self.step}


class LighthouseClient:
    def __init__(self, client):
        self._client = client

    def quorum(self, member: QuorumMember, timeout: float) -> Dict[str, Any]:
        result = self._client.call("quorum", {"member": member.to_dict()}, timeout)
        return result["quorum"]

    def heartbeat(self, replica_id: str, step: int, timeout: float) -> Dict[str, Any]:
        params: Dict[str, Any] = {"replica_id": replica_id}
        params["step"] = int(step)
        return self._client.call("heartbeat", params, timeout)
'''

MINI_CC = '''\
Json QuorumMember::to_json() const {
  Json j = Json::object();
  j["replica_id"] = replica_id;
  j["step"] = step;
  return j;
}

QuorumMember QuorumMember::from_json(const Json& j) {
  QuorumMember m;
  m.replica_id = j.get("replica_id").as_string();
  m.step = j.get("step").as_int();
  return m;
}

Json LighthouseServer::handle(const std::string& method, const Json& params,
                              int64_t timeout_ms) {
  if (method == "quorum") return rpc_quorum(params, timeout_ms);
  if (method == "heartbeat") {
    const std::string rid = params.get("replica_id").as_string();
    int64_t step = params.get("step").as_int(-1);
    Json out = Json::object();
    out["superseded"] = false;
    return out;
  }
  throw std::runtime_error("unknown method");
}

Json LighthouseServer::rpc_quorum(const Json& params, int64_t timeout_ms) {
  QuorumMember m = QuorumMember::from_json(params.get("member"));
  Json out = Json::object();
  out["quorum"] = m.to_json();
  return out;
}
'''

MINI_DOCS = """\
# protocol

## Wire surface

| server | method | notes |
|---|---|---|
| lighthouse | quorum | join the next quorum |
| lighthouse | heartbeat | liveness + progress |
"""

#: Envelope-surface mini project (the selftest's second half): a Python
#: _RpcClient building the request envelope and the native serve_conn /
#: RpcClient reading+writing it.
MINI_ENVELOPE_PY = '''\
import json


class _RpcClient:
    def call(self, method, params, timeout):
        req = {"method": method, "params": params, "timeout_ms": 1}
        req["traceparent"] = "00-x-y-01"
        payload = json.dumps(req).encode()
        return payload
'''

MINI_NET_CC = '''\
void RpcServer::serve_conn(int fd) {
  Json req = Json::parse(payload);
  int64_t timeout_ms = req.get("timeout_ms").as_int(60000);
  std::string method = req.get("method").as_string();
  TraceCtx ctx = parse_traceparent(req.get("traceparent").as_string());
  handle(method, req.get("params"), timeout_ms);
}

Json RpcClient::call(const std::string& method, const Json& params,
                     int64_t timeout_ms) {
  Json req = Json::object();
  req["method"] = method;
  req["params"] = params;
  req["timeout_ms"] = timeout_ms;
  req["traceparent"] = format_traceparent(current_trace());
  return req;
}
'''

MINI_ENVELOPE_DOCS = (
    MINI_DOCS
    + '\nEnvelope fields: `method`, `params`, `timeout_ms`, `traceparent`.\n'
)


def selftest() -> None:
    native = {"lighthouse.cc": MINI_CC}
    lock = build_lock(MINI_PY, native)

    def codes(py: str = MINI_PY, cc: str = MINI_CC, docs: str = MINI_DOCS,
              committed: Optional[Dict[str, Any]] = lock) -> Set[str]:
        return {
            f.code
            for f in run_checks(
                py, {"lighthouse.cc": cc}, docs, committed
            )
        }

    clean = codes()
    if clean:
        raise SelftestError(f"clean mini project yields findings: {clean}")
    # extraction sanity: the lock carries what the surfaces declare
    lh = lock["servers"]["lighthouse"]
    if set(lh) != {"quorum", "heartbeat"}:
        raise SelftestError(f"method extraction wrong: {sorted(lh)}")
    if lh["heartbeat"]["params"] != {"replica_id": "string", "step": "int"}:
        raise SelftestError(
            f"heartbeat param extraction wrong: {lh['heartbeat']['params']}"
        )
    if lock["structs"]["QuorumMember"] != {
        "replica_id": "string",
        "step": "int",
    }:
        raise SelftestError(
            f"struct extraction wrong: {lock['structs']['QuorumMember']}"
        )
    # each drift class is caught
    cases = {
        "param-dead": (
            MINI_PY.replace('params["step"] = int(step)',
                            'params["stepz"] = int(step)'),
            MINI_CC,
            MINI_DOCS,
        ),
        "struct-field-missing": (
            MINI_PY,
            MINI_CC.replace('j["step"] = step;', 'j["stepp"] = step;')
            .replace('m.step = j.get("step").as_int();',
                     'm.step = j.get("stepp").as_int();'),
            MINI_DOCS,
        ),
        "method-undocumented": (
            MINI_PY,
            MINI_CC,
            MINI_DOCS.replace("| lighthouse | heartbeat | liveness + progress |", ""),
        ),
        "type-mismatch": (
            MINI_PY.replace("replica_id: str", "replica_id: int"),
            MINI_CC,
            MINI_DOCS,
        ),
        "method-missing-native": (
            MINI_PY.replace('"heartbeat", params', '"heartbeatz", params'),
            MINI_CC,
            MINI_DOCS,
        ),
    }
    for expect, (py, cc, docs) in cases.items():
        got = codes(py, cc, docs)
        if expect not in got:
            raise SelftestError(
                f"seeded {expect} drift not caught (got {sorted(got)})"
            )
    # lock drift: committed lock from a different tree state
    stale = json.loads(json.dumps(lock))
    stale["structs"]["QuorumMember"]["renamed"] = stale["structs"][
        "QuorumMember"
    ].pop("step")
    got = codes(committed=stale)
    if "lock-drift" not in got:
        raise SelftestError(f"stale committed lock not caught (got {sorted(got)})")
    if "lock-missing" not in codes(committed=None):
        raise SelftestError("missing committed lock not caught")

    # ---- request-envelope surface ---------------------------------------
    env_py = MINI_PY + MINI_ENVELOPE_PY
    env_native = {"lighthouse.cc": MINI_CC, "net.cc": MINI_NET_CC}
    env_lock = build_lock(env_py, env_native)
    if env_lock["envelope"] != ["method", "params", "timeout_ms", "traceparent"]:
        raise SelftestError(
            f"envelope extraction wrong: {env_lock['envelope']}"
        )

    def env_codes(py: str = env_py, net: str = MINI_NET_CC) -> Set[str]:
        native = {"lighthouse.cc": MINI_CC, "net.cc": net}
        return {
            f.code
            for f in run_checks(
                py, native, MINI_ENVELOPE_DOCS,
                build_lock(py, native),
            )
        }

    clean = env_codes()
    if clean:
        raise SelftestError(f"clean envelope project yields findings: {clean}")
    got = env_codes(py=env_py.replace('req["traceparent"]', 'req["trace_parent"]'))
    if "envelope-field-dead" not in got or "envelope-field-missing" not in got:
        raise SelftestError(
            f"python-side envelope rename not caught (got {sorted(got)})"
        )
    got = env_codes(
        net=MINI_NET_CC.replace(
            'req.get("traceparent")', 'req.get("trace_parent")'
        )
    )
    if "envelope-field-dead" not in got or "envelope-field-missing" not in got:
        raise SelftestError(
            f"native-side envelope rename not caught (got {sorted(got)})"
        )
    docs_missing = {
        f.code
        for f in run_checks(
            env_py, env_native, MINI_DOCS, env_lock
        )
    }
    if "envelope-undocumented" not in docs_missing:
        raise SelftestError(
            f"undocumented envelope field not caught (got {sorted(docs_missing)})"
        )


PASS = LintPass(
    id=PASS_ID,
    doc=(
        "framed-JSON wire schema in sync across the Python clients, the "
        "native servers, docs/protocol.md, and the committed protocol.lock"
    ),
    run=_run,
    selftest=selftest,
)
