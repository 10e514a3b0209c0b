"""Model-parameter strings: the port's copy of the JAX package's
`get_dict_from_params_str` (elasticdl_tpu/common/model_utils.py)."""


def get_dict_from_params_str(params_str):
    """Parse 'k1=v1; k2=v2' model params with Python literal values; a
    value that is not a literal stays a string ("dtype=bf16")."""
    if not params_str:
        return {}
    out = {}
    for kv in params_str.split(";"):
        kv = kv.strip()
        if not kv:
            continue
        k, _, v = kv.partition("=")
        k, v = k.strip(), v.strip()
        try:
            out[k] = eval(v, {"__builtins__": {}}, {})
        except Exception:  # noqa: BLE001 - any non-literal stays a string
            out[k] = v
    return out
