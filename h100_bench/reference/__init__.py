"""The plain reference the benchmark judges the program's answers by.

Plain PyTorch, NumPy and SciPy: nothing here imports the program, and
nothing takes a factor, plan or bank the program made. Each reference
works its answer out from the matrix and right-hand sides the benchmark
handed to the program.
"""
