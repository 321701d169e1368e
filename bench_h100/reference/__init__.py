"""A plain reference of the MiMC-91 GKR proof: field, MiMC, verifier. It imports nothing of the program."""
