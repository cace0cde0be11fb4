"""The benchmark's tests. The CPU sizes of a configuration that came after
tiny.py's table was written are merged into that table here, when the
package loads, so that every run of a whole cell under benchmark/tests
(tiny_root) stays at CPU size."""
from benchmark.tests import tiny

tiny.TINY.setdefault("athal1008_snp", dict(
    n_fam=60, n_accessions=50, phenotypes=5, top_k=40, snps=3000))
