"""Criteo / DAC CTR feature configuration: the port's copy of
model_zoo/dac_ctr/feature_config.py (the reference's feature_config.py:
13 numeric features, standardized with the published means and standard
deviations and bucketized at the published boundaries, and 26 hashed
categorical features with the published distinct counts, one feature
an embedding group)."""

STANDARDIZED_FEATURES = ["I%d" % i for i in range(1, 14)]
BUCKET_FEATURES = ["I%d" % i for i in range(1, 14)]
HASH_FEATURES = ["C%d" % i for i in range(1, 27)]

FEATURES_AVGS = {
    "I1": 1.913844818114358, "I2": 105.85781137082337,
    "I3": 21.179428578076866, "I4": 5.735273873448716,
    "I5": 18067.71807784242, "I6": 90.08603360120591,
    "I7": 15.626512199091756, "I8": 12.509966404126569,
    "I9": 101.53250047174322, "I10": 0.3374528968790535,
    "I11": 2.614521353031052, "I12": 0.23277149534177055,
    "I13": 6.436560081179827,
}

FEATURES_STDDEVS = {
    "I1": 7.203044443387521, "I2": 391.73147156506417,
    "I3": 354.59360229869503, "I4": 8.351369642571008,
    "I5": 68611.11705989522, "I6": 340.20415627271075,
    "I7": 64.82617180501207, "I8": 16.71389239615237,
    "I9": 216.67850042198575, "I10": 0.5918310609867024,
    "I11": 5.115695237395591, "I12": 2.7609291491203973,
    "I13": 14.799688705863462,
}

FEATURE_BOUNDARIES = {
    "I1": [0.0, 1.0, 2.0, 5.0],
    "I2": [0.0, 1.0, 4.0, 16.0, 64.0],
    "I3": [1.0, 4.0, 16.0, 64.0],
    "I4": [1.0, 4.0, 8.0, 16.0],
    "I5": [64.0, 1024.0, 4096.0, 16384.0],
    "I6": [1.0, 8.0, 32.0, 128.0],
    "I7": [0.0, 1.0, 4.0, 16.0],
    "I8": [1.0, 4.0, 8.0, 16.0],
    "I9": [4.0, 16.0, 64.0, 256.0],
    "I10": [0.0, 1.0],
    "I11": [0.0, 1.0, 2.0, 4.0],
    "I12": [0.0, 1.0],
    "I13": [0.0, 1.0, 4.0, 8.0],
}

FEATURE_DISTINCT_COUNT = {
    "C1": 1460, "C2": 582, "C3": 9264260, "C4": 2046299, "C5": 305,
    "C6": 24, "C7": 12506, "C8": 633, "C9": 3, "C10": 91211,
    "C11": 5670, "C12": 7659856, "C13": 3194, "C14": 27, "C15": 14876,
    "C16": 5031503, "C17": 10, "C18": 5624, "C19": 2171, "C20": 4,
    "C21": 6477624, "C22": 18, "C23": 15, "C24": 272811, "C25": 101,
    "C26": 92253,
}

FEATURE_NAMES = STANDARDIZED_FEATURES + HASH_FEATURES

LABEL_KEY = "label"

# one feature per embedding group (I4 intentionally absent upstream)
FEATURE_GROUPS = [
    [f] for f in BUCKET_FEATURES if f != "I4"
] + [[f] for f in HASH_FEATURES]

MAX_HASHING_BUCKET_SIZE = 1000000
