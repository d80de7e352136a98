"""The plain reference: what a word_count job must write, worked out from
the generator's own draws, and the controls that break one guarantee of a
configuration. NumPy and Python only; imports nothing of the program."""
