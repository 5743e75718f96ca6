"""The plain reference of the benchmark's configurations: threefry
draws, RRR sets under IC and LT, greedy max-k-cover, RandGreedi with the
streaming receiver, IMM's rounds and the service's answers.  It imports
nothing of the program under test."""
