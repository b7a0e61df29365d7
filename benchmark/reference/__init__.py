"""The plain reference that decides `correct`.  It imports numpy and the
benchmark's frozen generators only: nothing of the program under test."""
