"""Plain fp32 references of the model families the benchmark serves. They
import nothing of the program, of ``jax`` or of ``repro``."""
