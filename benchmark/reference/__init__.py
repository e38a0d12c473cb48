"""The plain reference the check holds the program to: plain torch and
numpy, importing nothing of the program (see ../check.py)."""
