"""Scoring ops: trace encoding, the delay-mode scorer, the pair-distance
kernel and its build."""
