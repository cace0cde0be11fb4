"""Phenotype/kinship/table accession alignment (copy of
kmersgwas_tpu/pipeline/align.py, which has no JAX in it; the port keeps its
own copy).

Equivalents of src/awk/average_phenotypes.awk (mean-aggregate repeated
accessions) and src/py/align_kinship_phenotype.py (intersect the phenotype's
accessions with the kinship matrix and the table's column names, preserving
phenotype order, and cut the matching kinship sub-matrix).
"""
from __future__ import annotations

import numpy as np


def average_phenotypes(accessions, values):
    """Mean per accession, preserving first-appearance order.

    (The reference awk uses hash order; order only matters downstream through
    the intersection, which re-sorts by phenotype order anyway.)
    """
    values = np.asarray(values, dtype=np.float64)
    seen = {}
    order = []
    for a, v in zip(accessions, values):
        if a not in seen:
            seen[a] = [0.0, 0]
            order.append(a)
        seen[a][0] += float(v)
        seen[a][1] += 1
    out_vals = np.array([seen[a][0] / seen[a][1] for a in order])
    return order, out_vals


def intersect_accessions(pheno_accs, pheno_vals, kinship_names, K, table_names):
    """-> (used accession list, y, sub-kinship) in phenotype order.

    Mirrors align_kinship_phenotype.py:50-80: keep phenotype accessions that
    appear in BOTH the kinship name list and the table's .names.
    """
    kin_pos = {n: i for i, n in enumerate(kinship_names)}
    table_set = set(table_names)
    used, vals, kidx = [], [], []
    for a, v in zip(pheno_accs, np.asarray(pheno_vals, dtype=np.float64)):
        if a in kin_pos and a in table_set:
            used.append(a)
            vals.append(v)
            kidx.append(kin_pos[a])
    kidx = np.asarray(kidx, dtype=np.int64)
    K = np.asarray(K, dtype=np.float64)
    return used, np.asarray(vals), K[np.ix_(kidx, kidx)]
