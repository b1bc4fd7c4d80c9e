"""Plain references and the frozen yardstick arithmetic: nothing here
imports JAX or the program."""
