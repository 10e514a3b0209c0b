"""An independent Prometheus text-format parser (for verification): the
port of elasticdl_tpu/observability/promparse.py.

It shares nothing with the renderer in observability/metrics.py (no
helper, constant or regex), so a round trip through it cannot inherit
the renderer's faults. It parses text format 0.0.4 line by line and
validates as it goes:

* every sample belongs to a family announced by `# TYPE` (histogram
  samples only with `_bucket` / `_sum` / `_count`, counter samples
  ending in `_total`);
* metric and label names follow the Prometheus grammar; label values
  unescape `\\\\`, `\\"` and `\\n`; values parse as floats (`+Inf`,
  `-Inf`, `NaN` included);
* per histogram series (the same labels but `le`): `_bucket` counts
  monotone in `le`, a `+Inf` bucket, `_count` equal to it;
* OpenMetrics exemplars (``... # {trace_id="..."} 12.3 1722800000``)
  only on histogram `_bucket` samples, with at least one well-formed
  label, a finite value and, under a finite `le`, a value not above the
  bound. They land in each family's ``exemplars`` list as
  ``(metric_name, labels, exemplar_labels, value, unix_ts_or_None)``.

Any violation raises ValueError: a parse is a pass / fail check.
"""

import math

_NAME_FIRST = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:"
_NAME_REST = _NAME_FIRST + "0123456789"


def _valid_name(name):
    return (bool(name) and name[0] in _NAME_FIRST
            and all(ch in _NAME_REST for ch in name))


def _parse_float(text):
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def _parse_labels(text, lineno):
    """`key="value",...` (inside braces) -> dict, honoring escapes."""
    labels = {}
    i = 0
    while i < len(text):
        j = text.index("=", i)
        key = text[i:j]
        if not _valid_name(key) or ":" in key:
            raise ValueError(
                "line %d: bad label name %r" % (lineno, key)
            )
        if j + 1 >= len(text) or text[j + 1] != '"':
            raise ValueError(
                "line %d: unquoted label value" % lineno
            )
        i = j + 2
        out = []
        while True:
            if i >= len(text):
                raise ValueError(
                    "line %d: unterminated label value" % lineno
                )
            ch = text[i]
            if ch == "\\":
                nxt = text[i + 1:i + 2]
                if nxt == "n":
                    out.append("\n")
                elif nxt in ('"', "\\"):
                    out.append(nxt)
                else:
                    raise ValueError(
                        "line %d: bad escape \\%s" % (lineno, nxt)
                    )
                i += 2
                continue
            if ch == '"':
                i += 1
                break
            out.append(ch)
            i += 1
        labels[key] = "".join(out)
        if i < len(text):
            if text[i] != ",":
                raise ValueError(
                    "line %d: junk after label value: %r"
                    % (lineno, text[i:])
                )
            i += 1
    return labels


def _split_exemplar(line):
    """Split a SAMPLE line at its exemplar separator — the first `#`
    outside quoted label values — returning (main, exemplar_text or
    None). A `#` inside a quoted label value never splits."""
    in_quotes = False
    i = 0
    while i < len(line):
        ch = line[i]
        if ch == "\\" and in_quotes:
            i += 2
            continue
        if ch == '"':
            in_quotes = not in_quotes
        elif ch == "#" and not in_quotes:
            return line[:i].rstrip(), line[i + 1:].strip()
        i += 1
    return line, None


def _parse_exemplar(text, lineno):
    """`{labels} value [unix_ts]` -> (labels, value, ts_or_None)."""
    if not text.startswith("{"):
        raise ValueError(
            "line %d: exemplar must start with a label set, got %r"
            % (lineno, text)
        )
    close = text.find("}")
    if close < 0:
        raise ValueError(
            "line %d: unterminated exemplar label set" % lineno
        )
    labels = _parse_labels(text[1:close], lineno)
    if not labels:
        raise ValueError(
            "line %d: exemplar has no labels" % lineno
        )
    rest = text[close + 1:].split()
    if not rest or len(rest) > 2:
        raise ValueError(
            "line %d: exemplar needs `value [timestamp]`, got %r"
            % (lineno, text[close + 1:])
        )
    value = _parse_float(rest[0])
    if not (value == value and abs(value) != math.inf):
        raise ValueError(
            "line %d: exemplar value %r is not finite"
            % (lineno, rest[0])
        )
    ts = _parse_float(rest[1]) if len(rest) == 2 else None
    return labels, value, ts


def parse_prometheus_text(text):
    """Parse + validate one exposition. Returns
    {family: {"type": ..., "help": ..., "samples":
    [(metric_name, labels_dict, value)], "exemplars":
    [(metric_name, labels_dict, exemplar_labels, value, ts)]}}."""
    families = {}
    current = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not _valid_name(name):
                raise ValueError(
                    "line %d: bad family name %r" % (lineno, name)
                )
            families.setdefault(
                name, {"type": None, "help": None, "samples": [],
                       "exemplars": []}
            )["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2:
                raise ValueError("line %d: bad TYPE line" % lineno)
            name, mtype = parts
            if mtype not in ("counter", "gauge", "histogram",
                            "summary", "untyped"):
                raise ValueError(
                    "line %d: unknown type %r" % (lineno, mtype)
                )
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": [],
                       "exemplars": []}
            )
            fam["type"] = mtype
            current = name
            continue
        if line.startswith("#"):
            continue  # comment
        # sample line: name[{labels}] value [ts] [# exemplar]
        line, exemplar_text = _split_exemplar(line)
        brace = line.find("{")
        if brace >= 0:
            name = line[:brace]
            close = line.rindex("}")
            labels = _parse_labels(line[brace + 1:close], lineno)
            rest = line[close + 1:].split()
        else:
            parts = line.split()
            name, rest = parts[0], parts[1:]
            labels = {}
        if not _valid_name(name):
            raise ValueError(
                "line %d: bad metric name %r" % (lineno, name)
            )
        if not rest:
            raise ValueError("line %d: sample has no value" % lineno)
        value = _parse_float(rest[0])
        fam = _owning_family(families, name, current, lineno)
        families[fam]["samples"].append((name, labels, value))
        if exemplar_text is not None:
            if (families[fam]["type"] != "histogram"
                    or not name.endswith("_bucket")):
                raise ValueError(
                    "line %d: exemplar on %r — exemplars are only "
                    "valid on histogram _bucket samples"
                    % (lineno, name)
                )
            ex_labels, ex_value, ex_ts = _parse_exemplar(
                exemplar_text, lineno
            )
            le = _parse_float(labels.get("le", "+Inf"))
            if not math.isinf(le) and ex_value > le:
                raise ValueError(
                    "line %d: exemplar value %r above the bucket "
                    "bound le=%r — the bucket could never have "
                    "counted it" % (lineno, ex_value, le)
                )
            families[fam]["exemplars"].append(
                (name, labels, ex_labels, ex_value, ex_ts)
            )
    _validate(families)
    return families


def _owning_family(families, name, current, lineno):
    if name in families:
        return name
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[:-len(suffix)] in families:
            base = name[:-len(suffix)]
            if families[base]["type"] not in ("histogram", "summary"):
                raise ValueError(
                    "line %d: %r uses a histogram suffix but %r is a "
                    "%s" % (lineno, name, base, families[base]["type"])
                )
            return base
    if current is not None and name == current:
        return current
    raise ValueError(
        "line %d: sample %r belongs to no announced family"
        % (lineno, name)
    )


def _series_key(labels):
    return tuple(sorted(
        (k, v) for k, v in labels.items() if k != "le"
    ))


def _validate(families):
    for fam, info in families.items():
        if info["type"] is None:
            raise ValueError("family %r has samples but no TYPE" % fam)
        if info["type"] == "counter":
            for name, _labels, value in info["samples"]:
                if not name.endswith("_total"):
                    raise ValueError(
                        "counter sample %r does not end in _total"
                        % name
                    )
                if not (value >= 0 or math.isnan(value)):
                    raise ValueError(
                        "counter %r is negative: %r" % (name, value)
                    )
        if info["type"] != "histogram":
            continue
        buckets = {}
        counts = {}
        for name, labels, value in info["samples"]:
            key = _series_key(labels)
            if name == fam + "_bucket":
                if "le" not in labels:
                    raise ValueError(
                        "histogram %r bucket without le" % fam
                    )
                buckets.setdefault(key, []).append(
                    (_parse_float(labels["le"]), value)
                )
            elif name == fam + "_count":
                counts[key] = value
        for key, series in buckets.items():
            series.sort(key=lambda p: p[0])
            if not series or not math.isinf(series[-1][0]):
                raise ValueError(
                    "histogram %r series %r lacks a +Inf bucket"
                    % (fam, key)
                )
            last = -1.0
            for le, cum in series:
                if cum < last:
                    raise ValueError(
                        "histogram %r series %r buckets are not "
                        "monotone at le=%r" % (fam, key, le)
                    )
                last = cum
            if key in counts and counts[key] != series[-1][1]:
                raise ValueError(
                    "histogram %r series %r: _count %r != +Inf "
                    "bucket %r"
                    % (fam, key, counts[key], series[-1][1])
                )
