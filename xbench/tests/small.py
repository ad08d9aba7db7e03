"""The small shape the CPU tests run the cells at: every width of the
production configuration cut, enough stands (48) for the production
subselection, one slow dump every two windows, and gulps long enough
that the driver's staging ring holds the traffic's 15 (three windows of
five), as at LWA-352 shapes."""

SMALL = dict(nstand=48, nchan=16, ntime_gulp=192, acc_len=960,
             acc_len_slow=1920, nbeam=4, ntime_sum=12)
