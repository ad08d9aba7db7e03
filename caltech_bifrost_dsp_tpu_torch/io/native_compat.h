/* Forced into every source of the port's build of native/ (g++ -include).
 *
 * native/capture.cpp drains its socket with recvmmsg(..., MSG_WAITFORONE,
 * ...).  Some kernels (gVisor's, in user space) refuse that flag with
 * EINVAL, on which the engine's RX loop retries forever and captures
 * nothing.  Where the kernel refuses it, this wrapper gives the flag's
 * meaning by other calls: block for one datagram (the socket's
 * SO_RCVTIMEO still ends the wait), then take what else is queued without
 * blocking.  Elsewhere the call goes through unchanged.  sys/socket.h is
 * included first, so its declaration keeps its name and later includes
 * are no-ops. */
#ifndef CBD_NATIVE_COMPAT_H
#define CBD_NATIVE_COMPAT_H

#include <errno.h>
#include <sys/socket.h>

static inline int cbd_recvmmsg(int fd, struct mmsghdr *msgs,
                               unsigned int vlen, int flags,
                               struct timespec *timeout)
{
    int n = recvmmsg(fd, msgs, vlen, flags, timeout);
    if (n >= 0 || errno != EINVAL || !(flags & MSG_WAITFORONE)) {
        return n;
    }
    flags &= ~MSG_WAITFORONE;
    n = recvmmsg(fd, msgs, 1, flags, timeout);
    if (n != 1 || vlen == 1) {
        return n;
    }
    const int more = recvmmsg(fd, msgs + 1, vlen - 1, flags | MSG_DONTWAIT,
                              nullptr);
    return more > 0 ? 1 + more : 1;
}

#define recvmmsg cbd_recvmmsg

#endif /* CBD_NATIVE_COMPAT_H */
