"""Diagnostic probes of phase A's layouts (counterparts of the scripts
in ``docs/bench_diag/``): not product code, each run as a module."""
