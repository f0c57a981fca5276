"""The plain reference the benchmark holds the port's answers against."""
