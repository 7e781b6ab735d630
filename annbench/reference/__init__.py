"""The plain reference of the benchmark (imports nothing of the system under test)."""
