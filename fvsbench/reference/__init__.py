"""The benchmark's plain reference: exact filtered k-NN and the checks of
every answer, in plain PyTorch.  It imports nothing of the program."""
