"""Frozen copies of the port's yardsticks: the traffic generators, the byte
count of the probe_hits kernel and the host-seconds wrapper.  Each file
names the file and commit it was copied from."""
