"""Plain PyTorch reference of the benchmark's configurations. It imports
nothing of the program and takes nothing the program made."""
