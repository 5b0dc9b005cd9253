"""DA core: the bit-plane identity, quantization, the engine and freeze."""
