"""Plain PyTorch references of the benchmarked configurations: no kernel,
no batching across requests beyond what the model itself does, and no
import of the program."""
