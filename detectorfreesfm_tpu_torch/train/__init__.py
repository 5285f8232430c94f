"""Training: depth-warp supervision, losses, optimizers and trainers."""
