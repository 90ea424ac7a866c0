"""The benchmark's own yardstick: peaks of the card, model FLOPs a token
and the bytes each kernel call needs, frozen here so that no change to
the program moves them. Each kernel has a file of its own, named as the
program's launch counter names it."""
