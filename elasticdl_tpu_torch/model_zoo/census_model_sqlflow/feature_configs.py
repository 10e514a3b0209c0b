"""The census wide&deep transform config as parsed from SQLFlow: the
port's copy of model_zoo/census_model_sqlflow/feature_configs.py (the
reference's wide_and_deep/feature_configs.py:31-268: the public
census-income vocabularies and boundaries, the three feature groups and
the towers' wiring). Column names are those of the raw census records
(data/recordio_gen.gen_census_raw).

The op list is not in execution order: census_wide_and_deep.py sorts it
with transform_ops.topo_sort.
"""

import numpy as np

from elasticdl_tpu_torch.model_zoo.census_model_sqlflow.transform_ops import (  # noqa: E501
    Array,
    Bucketize,
    Concat,
    Embedding,
    Hash,
    SchemaInfo,
    Vocabularize,
    id_offsets_from_bucket_nums,
)

WORK_CLASS_VOCABULARY = [
    "Private", "Self-emp-not-inc", "Self-emp-inc", "Federal-gov",
    "Local-gov", "State-gov", "Without-pay", "Never-worked",
]
MARITAL_STATUS_VOCABULARY = [
    "Married-civ-spouse", "Divorced", "Never-married", "Separated",
    "Widowed", "Married-spouse-absent", "Married-AF-spouse",
]
RELATION_SHIP_VOCABULARY = [
    "Wife", "Own-child", "Husband", "Not-in-family", "Other-relative",
    "Unmarried",
]
RACE_VOCABULARY = [
    "White", "Asian-Pac-Islander", "Amer-Indian-Eskimo", "Other", "Black",
]
SEX_VOCABULARY = ["Female", "Male"]

AGE_BOUNDARIES = [0, 20, 40, 60, 80]
CAPITAL_GAIN_BOUNDARIES = [6000, 6500, 7000, 7500, 8000]
CAPITAL_LOSS_BOUNDARIES = [2000, 2500, 3000, 3500, 4000]
HOURS_BOUNDARIES = [10, 20, 30, 40, 50, 60]

LABEL_KEY = "label"

education_hash = Hash("education_hash", "education", "education_hash", 30)
occupation_hash = Hash("occupation_hash", "occupation", "occupation_hash",
                       30)
native_country_hash = Hash(
    "native_country_hash", "native-country", "native_country_hash", 100
)

workclass_lookup = Vocabularize(
    "workclass_lookup", "workclass", "workclass_lookup",
    vocabulary_list=WORK_CLASS_VOCABULARY,
)
marital_status_lookup = Vocabularize(
    "marital_status_lookup", "marital-status", "marital_status_lookup",
    vocabulary_list=MARITAL_STATUS_VOCABULARY,
)
relationship_lookup = Vocabularize(
    "relationship_lookup", "relationship", "relationship_lookup",
    vocabulary_list=RELATION_SHIP_VOCABULARY,
)
race_lookup = Vocabularize(
    "race_lookup", "race", "race_lookup", vocabulary_list=RACE_VOCABULARY
)
sex_lookup = Vocabularize(
    "sex_lookup", "sex", "sex_lookup", vocabulary_list=SEX_VOCABULARY
)

age_bucketize = Bucketize(
    "age_bucketize", "age", "age_bucketize", boundaries=AGE_BOUNDARIES
)
capital_gain_bucketize = Bucketize(
    "capital_gain_bucketize", "capital-gain", "capital_gain_bucketize",
    boundaries=CAPITAL_GAIN_BOUNDARIES,
)
capital_loss_bucketize = Bucketize(
    "capital_loss_bucketize", "capital-loss", "capital_loss_bucketize",
    boundaries=CAPITAL_LOSS_BOUNDARIES,
)
hours_per_week_bucketize = Bucketize(
    "hours_per_week_bucketize", "hours-per-week",
    "hours_per_week_bucketize", boundaries=HOURS_BOUNDARIES,
)

_GROUP1_MEMBERS = [
    workclass_lookup, hours_per_week_bucketize, capital_gain_bucketize,
    capital_loss_bucketize,
]
_GROUP2_MEMBERS = [
    education_hash, marital_status_lookup, relationship_lookup,
    occupation_hash,
]
_GROUP3_MEMBERS = [
    age_bucketize, sex_lookup, race_lookup, native_country_hash,
]


def _concat_group(name, members):
    return Concat(
        name,
        [m.output for m in members],
        name,
        id_offsets=id_offsets_from_bucket_nums(
            [m.num_buckets for m in members]
        ),
    )


def _group_dim(members):
    return sum(m.num_buckets for m in members)


group1 = _concat_group("group1", _GROUP1_MEMBERS)
group2 = _concat_group("group2", _GROUP2_MEMBERS)
group3 = _concat_group("group3", _GROUP3_MEMBERS)

group1_embedding_wide = Embedding(
    "group1_embedding_wide", "group1", "group1_embedding_wide",
    input_dim=_group_dim(_GROUP1_MEMBERS), output_dim=1,
)
group2_embedding_wide = Embedding(
    "group2_embedding_wide", "group2", "group2_embedding_wide",
    input_dim=_group_dim(_GROUP2_MEMBERS), output_dim=1,
)
group1_embedding_deep = Embedding(
    "group1_embedding_deep", "group1", "group1_embedding_deep",
    input_dim=_group_dim(_GROUP1_MEMBERS), output_dim=8,
)
group2_embedding_deep = Embedding(
    "group2_embedding_deep", "group2", "group2_embedding_deep",
    input_dim=_group_dim(_GROUP2_MEMBERS), output_dim=8,
)
group3_embedding_deep = Embedding(
    "group3_embedding_deep", "group3", "group3_embedding_deep",
    input_dim=_group_dim(_GROUP3_MEMBERS), output_dim=8,
)

wide_embeddings = Array(
    "wide_embeddings",
    ["group1_embedding_wide", "group2_embedding_wide"],
    "wide_embeddings",
)
deep_embeddings = Array(
    "deep_embeddings",
    [
        "group1_embedding_deep", "group2_embedding_deep",
        "group3_embedding_deep",
    ],
    "deep_embeddings",
)

TRANSFORM_OUTPUTS = ["wide_embeddings", "deep_embeddings"]

# Deliberately NOT in execution order (reference shipped it pre-sorted;
# the consumer topo-sorts).
FEATURE_TRANSFORM_INFO = [
    wide_embeddings,
    deep_embeddings,
    group1, group2, group3,
    group1_embedding_wide, group2_embedding_wide,
    group1_embedding_deep, group2_embedding_deep, group3_embedding_deep,
    education_hash, occupation_hash, native_country_hash,
    workclass_lookup, marital_status_lookup, relationship_lookup,
    race_lookup, sex_lookup,
    age_bucketize, capital_gain_bucketize, capital_loss_bucketize,
    hours_per_week_bucketize,
]

INPUT_SCHEMAS = [
    SchemaInfo("education", np.str_),
    SchemaInfo("occupation", np.str_),
    SchemaInfo("native-country", np.str_),
    SchemaInfo("workclass", np.str_),
    SchemaInfo("marital-status", np.str_),
    SchemaInfo("relationship", np.str_),
    SchemaInfo("race", np.str_),
    SchemaInfo("sex", np.str_),
    SchemaInfo("age", np.float32),
    SchemaInfo("capital-gain", np.float32),
    SchemaInfo("capital-loss", np.float32),
    SchemaInfo("hours-per-week", np.float32),
]
