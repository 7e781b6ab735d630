"""Index configuration (counterpart of ``spfresh_tpu/index/config.py``).

Same schema, keys, defaults and ``validate()`` as the JAX package, so a
``Config.to_dict()`` from either package loads in the other.

Config files are read and written by this module's own YAML subset, with
no pyyaml: ``Config.from_file`` reads printable ASCII in block mappings
(nested to any depth, two spaces or more), ``#`` comments, blank lines,
plain and single-quoted strings, double-quoted ones with no escape but
``\\"`` and ``\\\\``, decimal ints, floats (``0.5``, ``1.0e-06``,
``.inf``, ``.nan``), ``true``/``false`` and ``null``/``~``/empty values,
resolving each plain scalar as pyyaml's ``safe_load`` does (YAML 1.1: so
``1e-3``, with no dot, is the string ``"1e-3"``, as there).  Whatever else
YAML 1.1 allows raises ``ValueError`` with the line number: flow ``{}`` and
``[]``, sequences, anchors, aliases, tags, block scalars, directives and
document markers, tabs, inconsistent indentation, duplicate keys, other
escapes, characters outside printable ASCII, and the plain scalars that
pyyaml would read as something this subset does not write
(``yes``/``no``/``on``/``off``, octal, hex, ``1_000``, ``1:30``,
timestamps, ``<<``, ``=``).  ``str(cfg)`` writes ``to_dict()`` as
``yaml.safe_dump(..., sort_keys=False)`` does; a string that safe_dump
would double-quote (outside printable ASCII) or fold over two lines (a
lone space past column 80) raises ``ValueError`` instead.

The one key the port keeps for format compatibility but does not act on:
``search.engine`` (the port has one search pipeline: the slab rerank
kernel on CUDA, its plain version on the CPU).  ``build_sample_rows``
(the out-of-core build: a sample fit, then streamed passes of
``build_tile_rows`` rows, default 65,536, over a host corpus),
``storage_dtype: int8`` (residual IVF-SQ8) and the ``search.query_wire``
values ``bfloat16`` and ``int8`` act as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Any, Dict, Optional

from spfresh_tpu_torch.clustering.hierarchical import ClusteringParams, canonical_init
from spfresh_tpu_torch.ops.distances import canonical_metric


@dataclasses.dataclass
class SearchConfig:
    nprobe: Optional[int] = None  # None -> nprobe = k (reference behavior)
    prune_factor: Optional[float] = None  # e.g. 1.2 for reference-style pruning
    query_batch_size: int = 4096
    engine: str = "auto"
    # Spare member slots per posting slab (pad headroom for live inserts).
    slab_growth_slots: int = 16
    query_wire: Optional[str] = None

    def validate(self) -> None:
        if self.query_wire not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(
                "search.query_wire must be None, 'float32', 'bfloat16', "
                "or 'int8'"
            )
        if self.slab_growth_slots < 0:
            raise ValueError("search.slab_growth_slots must be >= 0")
        if self.nprobe is not None and self.nprobe <= 0:
            raise ValueError("search.nprobe must be > 0")
        if self.prune_factor is not None and self.prune_factor < 1.0:
            raise ValueError("search.prune_factor must be >= 1.0")
        if self.query_batch_size <= 0:
            raise ValueError("search.query_batch_size must be > 0")
        if self.engine not in ("auto", "pallas", "xla"):
            raise ValueError("search.engine must be 'auto', 'pallas', or 'xla'")


@dataclasses.dataclass
class Config:
    distance_metric: str = "Euclidean"
    initialization_method: str = "Random"
    initial_k: int = 4
    output_path: str = "data"
    data_file: Optional[str] = None
    desired_cluster_size: Optional[int] = None  # None -> round(0.18 * n)
    rng_seed: Optional[int] = None
    replication: str = "final"
    max_replicas: int = 4
    boundary_threshold: float = 1.1
    replica_overflow: float = 1.25
    max_split_ways: int = 8
    # None = AUTO: lambda 0.5 on Euclidean, off otherwise.
    soar_lambda: Optional[float] = None
    storage_dtype: str = "float32"  # or "bfloat16" or "int8"
    build_sample_rows: Optional[int] = None
    build_tile_rows: Optional[int] = None
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)

    _TOP_KEYS = frozenset({
        "output_path", "data_file", "storage_dtype",
        "build_sample_rows", "build_tile_rows",
    })
    _CP_KEYS = frozenset({
        "distance_metric", "initialization_method", "initial_k",
        "desired_cluster_size", "rng_seed", "replication", "max_replicas",
        "boundary_threshold", "replica_overflow", "max_split_ways",
        "soar_lambda",
    })
    _SC_KEYS = frozenset({
        "nprobe", "prune_factor", "query_batch_size", "engine",
        "slab_growth_slots", "query_wire",
    })

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        raw = dict(raw or {})
        cp = dict(raw.pop("clustering_params", {}) or {})
        sc = dict(raw.pop("search", {}) or {})
        for name, got, ok in (
            ("config", raw.keys(), cls._TOP_KEYS),
            ("clustering_params", cp.keys(), cls._CP_KEYS),
            ("search", sc.keys(), cls._SC_KEYS),
        ):
            unknown = sorted(set(got) - ok)
            if unknown:
                raise ValueError(
                    f"unknown {name} key(s) {unknown}; valid: {sorted(ok)}"
                )
        cfg = cls(
            distance_metric=cp.get("distance_metric", "Euclidean"),
            initialization_method=cp.get("initialization_method", "Random"),
            initial_k=int(cp.get("initial_k", 4)),
            output_path=raw.get("output_path", "data"),
            data_file=raw.get("data_file"),
            desired_cluster_size=cp.get("desired_cluster_size"),
            rng_seed=cp.get("rng_seed"),
            replication=cp.get("replication", "final"),
            max_replicas=int(cp.get("max_replicas", 4)),
            boundary_threshold=float(cp.get("boundary_threshold", 1.1)),
            replica_overflow=float(cp.get("replica_overflow", 1.25)),
            max_split_ways=int(cp.get("max_split_ways", 8)),
            soar_lambda=(
                float(cp["soar_lambda"])
                if cp.get("soar_lambda") is not None
                else None
            ),
            storage_dtype=raw.get("storage_dtype", "float32"),
            build_sample_rows=(
                int(raw["build_sample_rows"])
                if raw.get("build_sample_rows") is not None
                else None
            ),
            build_tile_rows=(
                int(raw["build_tile_rows"])
                if raw.get("build_tile_rows") is not None
                else None
            ),
            search=SearchConfig(
                nprobe=sc.get("nprobe"),
                prune_factor=sc.get("prune_factor"),
                query_batch_size=int(sc.get("query_batch_size", 4096)),
                engine=sc.get("engine", "auto"),
                slab_growth_slots=int(sc.get("slab_growth_slots", 16)),
                query_wire=sc.get("query_wire"),
            ),
        )
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Config":
        with open(path, "r", encoding="utf-8") as f:
            raw = load_yaml(f.read())
        return cls.from_dict(raw or {})

    def validate(self) -> None:
        canonical_metric(self.distance_metric)
        canonical_init(self.initialization_method)
        if self.initial_k <= 0:
            raise ValueError("initial_k must be greater than 0")
        if self.desired_cluster_size is not None and self.desired_cluster_size <= 0:
            raise ValueError("desired_cluster_size must be greater than 0")
        if self.storage_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                "storage_dtype must be 'float32', 'bfloat16' or 'int8'"
            )
        if self.soar_lambda is not None:
            if self.soar_lambda < 0:
                raise ValueError("soar_lambda must be >= 0")
            if self.soar_lambda and canonical_metric(self.distance_metric) != "Euclidean":
                raise ValueError("soar_lambda requires the Euclidean metric")
        if self.build_sample_rows is not None and self.build_sample_rows <= 0:
            raise ValueError("build_sample_rows must be greater than 0")
        if self.build_tile_rows is not None and self.build_tile_rows <= 0:
            raise ValueError("build_tile_rows must be greater than 0")
        self.search.validate()

    def to_clustering_params(self) -> ClusteringParams:
        return ClusteringParams(
            metric=canonical_metric(self.distance_metric),
            initialization_method=canonical_init(self.initialization_method),
            desired_cluster_size=self.desired_cluster_size,
            initial_k=self.initial_k,
            rng_seed=self.rng_seed,
            replication=self.replication,
            max_replicas=self.max_replicas,
            boundary_threshold=self.boundary_threshold,
            replica_overflow=self.replica_overflow,
            max_split_ways=self.max_split_ways,
            # None = auto: SOAR on for Euclidean builds, off for L1/Linf.
            soar_lambda=(
                self.soar_lambda
                if self.soar_lambda is not None
                else (
                    0.5
                    if canonical_metric(self.distance_metric) == "Euclidean"
                    else None
                )
            ),
            # Non-f32 storage builds from the bf16-rounded corpus, as the
            # JAX package does (its bf16 corpus wire).
            wire_dtype=(
                "bfloat16" if self.storage_dtype != "float32" else None
            ),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "clustering_params": {
                "distance_metric": self.distance_metric,
                "initialization_method": self.initialization_method,
                "initial_k": self.initial_k,
                "desired_cluster_size": self.desired_cluster_size,
                "rng_seed": self.rng_seed,
                "replication": self.replication,
                "max_replicas": self.max_replicas,
                "boundary_threshold": self.boundary_threshold,
                "replica_overflow": self.replica_overflow,
                "max_split_ways": self.max_split_ways,
                "soar_lambda": self.soar_lambda,
            },
            "output_path": self.output_path,
            "data_file": self.data_file,
            "storage_dtype": self.storage_dtype,
            "build_sample_rows": self.build_sample_rows,
            "build_tile_rows": self.build_tile_rows,
            "search": {
                "nprobe": self.search.nprobe,
                "prune_factor": self.search.prune_factor,
                "query_batch_size": self.search.query_batch_size,
                "engine": self.search.engine,
                "slab_growth_slots": self.search.slab_growth_slots,
                "query_wire": self.search.query_wire,
            },
        }

    def __str__(self) -> str:  # the JAX package's Display parity
        return dump_yaml(self.to_dict())


# ---------------------------------------------------------------------------
# The YAML subset (see the module docstring)
# ---------------------------------------------------------------------------

# pyyaml's implicit resolvers (YAML 1.1), in its order: a plain scalar that
# matches one of these is not a string.
_YAML11 = (
    ("bool", re.compile(r"(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)")),
    ("float", re.compile(r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))")),
    ("int", re.compile(r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)")),
    ("merge", re.compile(r"<<")),
    ("null", re.compile(r"~|null|Null|NULL|")),
    ("timestamp", re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                             r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                             r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                             r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?")),
    ("value", re.compile(r"=")),
)
# The forms of those that this subset reads.
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOATS = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                   "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                   "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                   ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
# What this subset reads and writes: printable ASCII (a tab is refused
# on its own, with its own message).
_OUTSIDE = re.compile(r"[^\t\n\r\x20-\x7E]")
# A string that safe_dump will not write plain in a block mapping: an
# indicator first, a leading or trailing space, ": ", " #", a final ":".
_NOT_PLAIN = re.compile(r"^(?:---|\.\.\.|[-?:](?: |$)|[#,\[\]{}&*!|>'\"%@`]| )|: |:$| #| $")
# safe_dump's line width: past it, a single space in a value starts a new line.
_WIDTH = 80


def _yaml11_tag(text: str) -> str:
    """The type pyyaml's ``safe_load`` gives the plain scalar ``text``."""
    for tag, rx in _YAML11:
        if rx.fullmatch(text):
            return tag
    return "str"


def _plain_value(text: str, where: str):
    """A plain scalar as ``safe_load`` reads it, or ``ValueError`` for the
    YAML 1.1 forms outside the subset."""
    tag = _yaml11_tag(text)
    if tag == "str":
        return text
    if tag == "null":
        return None
    if tag == "bool" and text in _BOOLS:
        return _BOOLS[text]
    if tag == "int" and _INT.fullmatch(text):
        return int(text)
    if tag == "float" and text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if tag == "float" and _FLOAT.fullmatch(text):
        return float(text)
    raise ValueError(f"{where}: {text!r} is a YAML 1.1 {tag} in a form this reader does not "
                     "take; quote it for a string")


def _quoted(body: str, where: str):
    """(value, rest of the line) of the quoted scalar that ``body`` starts."""
    q, out, i = body[0], [], 1
    while i < len(body):
        ch = body[i]
        if ch == q:
            if q == "'" and body[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), body[i + 1:]
        if q == '"' and ch == "\\":
            esc = body[i + 1:i + 2]
            if esc not in ('"', "\\"):
                raise ValueError(f"{where}: only the escapes \\\" and \\\\ are read, not "
                                 f"\\{esc} (or a string that goes on past the line)")
            out.append(esc)
            i += 2
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"{where}: a quoted string must end on its line")


def _scalar(body: str, where: str):
    """The value of ``body``, the text after ``key:`` with its leading
    spaces removed."""
    if body[:1] in ("'", '"'):
        value, rest = _quoted(body, where)
        rest = rest.strip(" ")
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after a quoted string: {rest!r}")
        return value
    if body[:1] in tuple(",[]{}&*!|>%@`") or body[:2] in ("- ", "? ", ": ") or body in "-?:":
        raise ValueError(f"{where}: {body!r}: flow collections, sequences, anchors, aliases, "
                         "tags, block scalars and reserved indicators are not read")
    cut = body.find(" #")
    text = (body if cut < 0 else body[:cut]).rstrip(" ")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: a mapping inside a value, or a plain string holding "
                         "': ' (quote it)")
    return _plain_value(text, where)


def load_yaml(text: str) -> Optional[Dict[str, Any]]:
    """The mapping of a YAML document in the subset, as ``yaml.safe_load``
    gives it (None for a document with no content); ``ValueError`` with
    the line number for anything outside the subset."""
    bad = _OUTSIDE.search(text)
    if bad:
        line = text.count("\n", 0, bad.start()) + 1
        raise ValueError(f"line {line}: character {bad.group()!r}: only printable ASCII is read")
    root: Dict[str, Any] = {}
    stack = []  # (indent of the keys, mapping), outermost first
    pending = None  # (indent, mapping, key) of a key whose value is still empty
    for no, line in enumerate(text.splitlines(), 1):
        where = f"line {no}"
        if "\t" in line:
            raise ValueError(f"{where}: tabs are not read")
        content = line.lstrip(" ")
        if not content or content.startswith("#"):
            continue
        indent = len(line) - len(content)
        if content.startswith("%") or content.rstrip(" ") in ("---", "...") \
                or content.startswith(("--- ", "... ")):
            raise ValueError(f"{where}: directives and document markers are not read")
        if not stack:
            stack.append((indent, root))
        elif pending is not None and indent > pending[0]:
            child: Dict[str, Any] = {}
            pending[1][pending[2]] = child
            stack.append((indent, child))
        pending = None
        while indent < stack[-1][0]:
            stack.pop()
            if not stack:
                break
        if not stack or indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        m = re.match(r"([^:]*?):(?: +|$)", content)
        key = m.group(1) if m else None
        if key is None or not _KEY.fullmatch(key) or _yaml11_tag(key) != "str":
            raise ValueError(f"{where}: expected 'key: value' with a plain identifier key, "
                             f"got {content!r}")
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        body = content[m.end():].rstrip(" ")
        if not body or body.startswith("#"):
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _scalar(body, where)
    return root if stack else None


def _str_text(s: str) -> str:
    """``s`` as safe_dump writes a string scalar: plain where it may be,
    else single-quoted.  A string safe_dump would double-quote (one
    holding a character outside printable ASCII) raises ``ValueError``."""
    bad = re.search(r"[^\x20-\x7E]", s)
    if bad:
        raise ValueError(f"cannot write {s!r}: {bad.group()!r} is outside printable ASCII")
    if s and _yaml11_tag(s) == "str" and not _NOT_PLAIN.search(s):
        return s
    return "'" + s.replace("'", "''") + "'"


def _value_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        return _str_text(v)
    raise ValueError(f"cannot write {type(v).__name__} {v!r} in a config file")


def dump_yaml(mapping: Dict[str, Any], indent: int = 0) -> str:
    """``mapping`` as ``yaml.safe_dump(mapping, sort_keys=False)`` writes
    it (block style, two-space indent), each value on one line: a string
    that safe_dump would fold over two lines (a lone space past column
    80) raises ``ValueError``."""
    out = []
    for key, v in mapping.items():
        head = " " * indent + _value_text(key) + ":"
        if isinstance(v, dict):
            out.append(head + "\n" + dump_yaml(v, indent + 2) if v else head + " {}\n")
            continue
        text = _value_text(v)
        lo = int(text.startswith("'"))  # the quote before a quoted string's text
        body = text[lo:len(text) - lo]
        for m in re.finditer(r"(?<! ) (?! )", body):
            if 0 < m.start() < len(body) - 1 and len(head) + 1 + lo + m.start() > _WIDTH:
                raise ValueError(f"cannot write {v!r} on one line: safe_dump folds it at "
                                 f"column {_WIDTH}")
        out.append(f"{head} {text}\n")
    return "".join(out)
