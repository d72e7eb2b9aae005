"""Plain PyTorch reference of the UPP models and steps the benchmark checks
the program against. It imports nothing of the program."""
