"""The plain fp32 reference the check compares the program with."""
