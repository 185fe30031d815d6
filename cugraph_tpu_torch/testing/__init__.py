from .datasets import (
    karate_edgelist,
    dolphins_edgelist,
    email_eu_core_edgelist,
    netscience_edgelist,
    load_csv_edgelist,
    DATASET_DIR,
)
