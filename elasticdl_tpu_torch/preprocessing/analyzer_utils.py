"""Transform-parameter accessors for the SQLFlow analysis pass: the port's
copy of elasticdl_tpu/preprocessing/analyzer_utils.py (torch-free).

Parity with elasticdl_preprocessing/utils/analyzer_utils.py:23-160 and
constants.py:15-22 (`AnalysisEnvTemplate`): in the reference, a SQLFlow
table-analysis pass exports per-feature statistics into environment
variables (``_<feature>_min``, ``_<feature>_stddev``, ...) and these
accessors read them by feature NAME, falling back to a caller default
(so unit tests run without the pass). All seven accessors are here,
including ``get_distinct_count``.

Beyond the reference, each accessor also accepts a numpy column directly
(the analysis result does not have to ride the environment), and
``publish_analysis`` is the analysis pass itself — it computes a
column's statistics and exports them under the reference's env names,
so name-keyed reads round-trip without SQLFlow.
"""

import os

import numpy as np


class AnalysisEnvTemplate(object):
    """Reference elasticdl_preprocessing/constants.py:15-22."""

    MIN_ENV = "_{}_min"
    MAX_ENV = "_{}_max"
    AVG_ENV = "_{}_avg"
    STDDEV_ENV = "_{}_stddev"
    BUCKET_BOUNDARIES_ENV = "_{}_boundaries"
    DISTINCT_COUNT_ENV = "_{}_distinct_count"
    VOCABULARY_ENV = "_{}_vocab"


def _env(template, name):
    return os.getenv(template.format(name), None)


def _scalar(feature, default, template, reduce_fn):
    if feature is None:
        return default
    if isinstance(feature, str):
        value = _env(template, feature)
        return default if value is None else float(value)
    return float(reduce_fn(np.asarray(feature)))


def get_min(feature=None, default=0.0):
    """Min of a numeric feature: by column array, or by feature name
    from the analysis environment (reference analyzer_utils.py:23-40)."""
    return _scalar(feature, default, AnalysisEnvTemplate.MIN_ENV, np.min)


def get_max(feature=None, default=1.0):
    return _scalar(feature, default, AnalysisEnvTemplate.MAX_ENV, np.max)


def get_avg(feature=None, default=0.0):
    return _scalar(feature, default, AnalysisEnvTemplate.AVG_ENV, np.mean)


def get_stddev(feature=None, default=1.0):
    return _scalar(
        feature, default, AnalysisEnvTemplate.STDDEV_ENV, np.std
    )


def get_bucket_boundaries(feature=None, num_buckets=10, default=None):
    """Quantile boundaries (len = num_buckets - 1) from a column, or the
    sorted-deduped comma-separated env list by feature name (reference
    analyzer_utils.py:102-121)."""
    fallback = default if default is not None else []
    if feature is None:
        return fallback
    if isinstance(feature, str):
        value = _env(AnalysisEnvTemplate.BUCKET_BOUNDARIES_ENV, feature)
        if not value:  # unset OR published-empty (num_buckets <= 1)
            return fallback
        return sorted(set(map(float, value.split(","))))
    qs = np.linspace(0, 100, num_buckets + 1)[1:-1]
    return np.percentile(np.asarray(feature), qs).tolist()


def get_distinct_count(feature=None, default=0):
    """Count of distinct feature values (reference
    analyzer_utils.py:123-140)."""
    if feature is None:
        return default
    if isinstance(feature, str):
        value = _env(AnalysisEnvTemplate.DISTINCT_COUNT_ENV, feature)
        return default if value is None else int(value)
    return int(np.unique(np.asarray(feature).reshape(-1)).size)


def get_vocabulary(feature=None, default=None):
    """Vocabulary of a categorical feature: first-seen order from a
    column, or the env value by feature name — which the reference
    passes through verbatim (a vocabulary file path OR a
    comma-separated list; analyzer_utils.py:142-160). A comma-separated
    env value is split here so callers get a list either way; a path
    (no comma, has a separator) passes through."""
    fallback = default if default is not None else []
    if feature is None:
        return fallback
    if isinstance(feature, str):
        value = _env(AnalysisEnvTemplate.VOCABULARY_ENV, feature)
        if value is None:
            return fallback
        if value.startswith("["):
            # publish_analysis writes JSON so values containing commas
            # or path separators round-trip exactly
            import json

            try:
                return json.loads(value)
            except ValueError:
                pass
        if "," not in value and os.sep in value:
            return value  # vocabulary file path, reference passthrough
        return value.split(",")
    values = np.asarray(feature).reshape(-1)
    seen = {}
    for v in values:
        s = v.decode("utf-8") if isinstance(v, bytes) else str(v)
        seen.setdefault(s, None)
    return list(seen)


def publish_analysis(feature_name, column, num_buckets=10,
                     is_categorical=None):
    """The analysis pass itself: compute `column`'s statistics and
    export them under the reference env names, so subsequent name-keyed
    accessor calls (e.g. inside a generated SQLFlow model) resolve. The
    reference left this to SQLFlow's table analyzer; here it is one
    call. Returns the {env_name: value} map it set."""
    column = np.asarray(column)
    if is_categorical is None:
        is_categorical = not np.issubdtype(column.dtype, np.number)
    t = AnalysisEnvTemplate
    out = {}
    if is_categorical:
        import json as _json

        out[t.VOCABULARY_ENV.format(feature_name)] = _json.dumps(
            get_vocabulary(column)
        )
    else:
        out[t.MIN_ENV.format(feature_name)] = repr(get_min(column))
        out[t.MAX_ENV.format(feature_name)] = repr(get_max(column))
        out[t.AVG_ENV.format(feature_name)] = repr(get_avg(column))
        out[t.STDDEV_ENV.format(feature_name)] = repr(get_stddev(column))
        out[t.BUCKET_BOUNDARIES_ENV.format(feature_name)] = ",".join(
            repr(b) for b in get_bucket_boundaries(
                column, num_buckets=num_buckets
            )
        )
    out[t.DISTINCT_COUNT_ENV.format(feature_name)] = str(
        get_distinct_count(column)
    )
    os.environ.update(out)
    return out
