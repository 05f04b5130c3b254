"""Plain PyTorch references of what the cells time, in float32 with TF32
off.  They import nothing of the program and take nothing it made: the
benchmark hands them the inputs it made itself, and reads the program's
outputs only to judge them."""
