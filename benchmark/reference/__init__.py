"""The plain reference the program's answers are judged by.

Plain PyTorch, float64 (`precision.F64`), written from the plugin's
formulas and the engine's documented semantics; it imports nothing of the
program and takes nothing the program made but the answers it judges.
"""
