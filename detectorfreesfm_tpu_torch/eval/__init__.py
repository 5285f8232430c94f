"""Evaluation: the pairwise relative-pose AUC protocol, cross-scene
aggregation and point-cloud accuracy/completeness."""
