"""Signal front ends of the bearing models: STFT magnitudes and the
handcrafted feature stacks."""
