"""The port's binding of its native core against the core's own sources.

The port compiles its copy of the C++ core (``horovod_tpu_torch/native``)
and calls it through the ctypes table ``horovod_tpu_torch.basics._C_API``.
These tests read the sources, so they need no compiler: every
``hvdtpu_*`` function of ``core.cpp``'s ``extern "C"`` block is in the
table with its number of arguments and matching types and return type (as
the ABI-MIRROR rule of ``scripts/check_invariants.py`` holds the JAX
package's table to its core); the enum codes the port passes are the
copy's; the copy includes nothing from outside its directory, and the
build compiles exactly the copy.
"""

import ctypes
import re

import pytest

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops.collectives import ReduceOp
from horovod_tpu_torch.utils import native_build

NATIVE = native_build.NATIVE

# C type of a parameter or return value -> the ctypes types that carry it.
_CTYPES = {
    "int": {ctypes.c_int},
    "longlong": {ctypes.c_longlong},
    "double": {ctypes.c_double},
    "void*": {ctypes.c_void_p},
    "char*": {ctypes.c_char_p},
    "longlong*": {ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p},
    "int*": {ctypes.POINTER(ctypes.c_int), ctypes.c_void_p},
    "unsignedchar*": {ctypes.POINTER(ctypes.c_ubyte), ctypes.c_void_p},
    "float*": {ctypes.POINTER(ctypes.c_float), ctypes.c_void_p},
    "void": {None},
}


def _c_type(decl: str) -> str:
    """``const long long *sizes`` -> ``longlong*`` (the name dropped)."""
    decl = re.sub(r"\bconst\b", " ", decl)
    stars = decl.count("*")
    words = decl.replace("*", " ").split()
    kinds = {"int", "long", "char", "double", "float", "void", "unsigned",
             "short", "signed"}
    if len(words) > 1 and words[-1] not in kinds:
        words = words[:-1]
    if words[:1] == ["int64_t"]:
        words = ["long", "long"]
    if words[:1] == ["int32_t"]:
        words = ["int"]
    return "".join(words) + "*" * stars


def _exports():
    """{symbol: (return type, [parameter types])} of the definitions in
    core.cpp's extern "C" block."""
    text = (NATIVE / "core.cpp").read_text()
    start = text.index('extern "C" {')
    end = text.index('}  // extern "C"', start)
    block = text[start:end]
    out = {}
    for m in re.finditer(r"^([A-Za-z_][\w \*]*?)\s*\b(hvdtpu_\w+)\(",
                         block, re.M):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(block[i], 0)
            i += 1
        if not block[i:i + 8].lstrip().startswith("{"):
            continue  # a declaration, not the definition
        params = block[m.end():i - 1].strip()
        out[m.group(2)] = (_c_type(m.group(1)), [] if params in ("", "void")
                           else [_c_type(p) for p in params.split(",")])
    return out


def test_table_names_every_export():
    exports = _exports()
    table = {sym: (res, args) for sym, res, args in basics._C_API}
    assert len(exports) > 40, sorted(exports)
    assert set(table) == set(exports), (set(table) ^ set(exports))


@pytest.mark.parametrize("symbol", sorted(_exports()))
def test_signature_matches(symbol):
    ret, params = _exports()[symbol]
    restype, argtypes = {sym: (res, args)
                         for sym, res, args in basics._C_API}[symbol]
    assert restype in _CTYPES[ret], (symbol, ret, restype)
    assert len(argtypes) == len(params), (symbol, params, argtypes)
    for i, (c, py) in enumerate(zip(params, argtypes)):
        assert py in _CTYPES[c], (symbol, i, c, py)


def _enum(name: str):
    text = (NATIVE / "common.h").read_text()
    body = re.search(r"enum class %s : int32_t \{(.*?)\};" % name, text,
                     re.S).group(1)
    return {k.lower(): int(v) for k, v in
            re.findall(r"(\w+) = (\d+)", body)}


def test_codes_are_the_copys():
    assert _enum("OpType") == basics._OP_TYPES
    assert _enum("DataType") == {str(t).replace("torch.", ""): code
                                 for t, code in basics._DTYPES.items()}
    assert _enum("ReduceOp") == {op.name.lower(): int(op)
                                 for op in ReduceOp}


def test_sources_are_the_ports_own():
    """Every quoted include names a file of the directory, and the build
    compiles every .cpp there into the library (the unit tests'
    ``unit_tests.cpp`` into their own binary) and names nothing of the JAX
    package."""
    names = {p.name for p in NATIVE.iterdir()}
    for p in NATIVE.iterdir():
        for inc in re.findall(r'^#include "([^"]+)"', p.read_text(), re.M):
            assert "/" not in inc and inc in names, (p.name, inc)
    assert native_build.UNIT_TESTS.parent == NATIVE
    assert {p.name for p in native_build.SOURCES} | {
        native_build.UNIT_TESTS.name} == {
        n for n in names if n.endswith(".cpp")}
    assert native_build.UNIT_TESTS not in native_build.SOURCES
    assert all(p.parent == NATIVE for p in native_build.SOURCES)
    source = open(native_build.__file__).read()
    assert not re.search(r"horovod_tpu(?!_torch)\b", source)
    assert native_build.BUILD_DIR.parent == NATIVE.parent


def test_library_key_covers_every_source(tmp_path):
    for name in ("core.cpp", "common.h"):
        (tmp_path / name).write_text("a")
    key = native_build.source_key(tmp_path)
    (tmp_path / "common.h").write_text("b")
    edited = native_build.source_key(tmp_path)
    assert edited != key
    (tmp_path / "notes.txt").write_text("c")
    assert native_build.source_key(tmp_path) == edited
