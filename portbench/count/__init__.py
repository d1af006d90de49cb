"""Operations and bytes from a configuration's shapes, and the card's
peaks: frozen here, so that a change to the program cannot move the
yardstick."""
