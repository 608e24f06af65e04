"""The plain reference that decides ``correct``: numpy and PyTorch only,
nothing of the program."""
