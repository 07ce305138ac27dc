"""The plain PyTorch reference the benchmark holds the program against.
It imports nothing of the program under test."""
