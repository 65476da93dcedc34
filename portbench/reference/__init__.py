"""The benchmark's plain reference: the data generator and consensus
clustering worked out again in plain NumPy and PyTorch, independent of the
program it judges (it imports nothing of it)."""
