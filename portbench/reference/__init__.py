"""The plain reference: GPT2 with double heads, the corpus's
tokenization, the count sketch and the server step, in plain PyTorch
and numpy. Imports nothing of the program."""
