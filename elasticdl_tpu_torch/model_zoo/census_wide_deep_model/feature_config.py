"""Census wide&deep feature configuration: the port's copy of
model_zoo/census_wide_deep_model/feature_config.py (the reference's
feature_config.py: vocabularies, bucket boundaries, the three feature
groups, and which groups feed the wide and the deep towers)."""

import numpy as np

from elasticdl_tpu_torch.model_zoo.census_wide_deep_model.feature_info_util import (  # noqa: E501
    FeatureInfo,
    TransformOp,
    get_id_boundaries,
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

education = FeatureInfo("education", TransformOp.HASH, np.str_, 30)
occupation = FeatureInfo("occupation", TransformOp.HASH, np.str_, 30)
native_country = FeatureInfo(
    "native-country", TransformOp.HASH, np.str_, 100
)

workclass = FeatureInfo(
    "workclass", TransformOp.LOOKUP, np.str_, WORK_CLASS_VOCABULARY
)
marital_status = FeatureInfo(
    "marital-status", TransformOp.LOOKUP, np.str_, MARITAL_STATUS_VOCABULARY
)
relationship = FeatureInfo(
    "relationship", TransformOp.LOOKUP, np.str_, RELATION_SHIP_VOCABULARY
)
race = FeatureInfo("race", TransformOp.LOOKUP, np.str_, RACE_VOCABULARY)
sex = FeatureInfo("sex", TransformOp.LOOKUP, np.str_, SEX_VOCABULARY)

age = FeatureInfo("age", TransformOp.BUCKETIZE, np.float32, AGE_BOUNDARIES)
capital_gain = FeatureInfo(
    "capital-gain", TransformOp.BUCKETIZE, np.float32,
    CAPITAL_GAIN_BOUNDARIES,
)
capital_loss = FeatureInfo(
    "capital-loss", TransformOp.BUCKETIZE, np.float32,
    CAPITAL_LOSS_BOUNDARIES,
)
hours_per_week = FeatureInfo(
    "hours-per-week", TransformOp.BUCKETIZE, np.float32, HOURS_BOUNDARIES
)

FEATURE_GROUPS = {
    "group1": [workclass, hours_per_week, capital_gain, capital_loss],
    "group2": [education, marital_status, relationship, occupation],
    "group3": [age, sex, race, native_country],
}

MODEL_INPUTS = {
    "wide": ["group1", "group2"],
    "deep": ["group1", "group2", "group3"],
}

CATEGORICAL_FEATURE_KEYS = [
    "workclass", "education", "marital-status", "occupation",
    "relationship", "race", "sex", "native-country",
]
NUMERIC_FEATURE_KEYS = [
    "age", "capital-gain", "capital-loss", "hours-per-week",
]
LABEL_KEY = "label"


def get_id_group_dims():
    """{group_name: total id-space size} (reference get_id_group_dims)."""
    return {
        name: get_id_boundaries(features)[-1]
        for name, features in FEATURE_GROUPS.items()
    }
