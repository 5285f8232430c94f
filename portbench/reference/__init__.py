"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the program under test and read the bundled weights with their
own reader (`weights.py`)."""
