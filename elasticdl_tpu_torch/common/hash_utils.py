"""The port's copy of `string_to_id` (elasticdl_tpu/common/hash_utils.py):
categorical strings hash to ids as sha256 mod buckets, so both packages
map a record to the same embedding rows."""

import hashlib


def string_to_id(name, bucket_num):
    """sha256(name) mod bucket_num."""
    if bucket_num <= 0:
        raise ValueError("bucket_num must be positive, got %d" % bucket_num)
    digest = hashlib.sha256(name.encode("utf-8")).hexdigest()
    return int(digest, 16) % bucket_num
