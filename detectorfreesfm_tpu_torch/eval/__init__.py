"""Evaluation: the pairwise relative-pose AUC protocol."""
