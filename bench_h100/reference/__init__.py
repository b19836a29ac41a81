"""The plain reference (numpy), which imports nothing of the program."""
