/* The merlin subset of STROBE-128 over Keccak-f[1600], on the host.
 *
 * The byte-level operations of `merlin.py`'s Strobe128 (begin_op, absorb,
 * overwrite, squeeze, run_f) and Merlin's append_message, in C: the
 * transcript is sequential, so it stays on the host CPU, where a Python
 * byte loop and permutation would bound a Spartan setup at 2^20
 * constraints, which absorbs some two million 166-byte blocks.
 * Plain C, no headers but the C library's; built with the host's C
 * compiler at first use and loaded with ctypes (merlin.py). Lanes are
 * little-endian, as on every host the port runs on (x86-64, aarch64).
 */
#include <stdint.h>
#include <string.h>

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A 2
#define FLAG_C 4
#define FLAG_T 8
#define FLAG_M 16
#define FLAG_K 32

typedef struct {
    union {
        uint64_t lanes[25];
        uint8_t bytes[200];
    } st;
    int64_t pos, pos_begin, cur_flags;
} strobe_t;

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL, 0x8000000080008000ULL,
    0x000000000000808BULL, 0x0000000080000001ULL, 0x8000000080008081ULL, 0x8000000000008009ULL,
    0x000000000000008AULL, 0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
    0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800AULL, 0x800000008000000AULL,
    0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

/* rotation of lane x + 5y, and the lane pi sends it to */
static const int ROT[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
                            25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};

static inline uint64_t rotl(uint64_t x, int n) {
    return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccak_f1600(uint64_t *a) {
    uint64_t b[25], c[5], d[5];
    for (int r = 0; r < 24; r++) {
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) {
                int i = x + 5 * y;
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[i] ^ d[x], ROT[i]);
            }
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
        a[0] ^= RC[r];
    }
}

static void run_f(strobe_t *s) {
    s->st.bytes[s->pos] ^= (uint8_t)s->pos_begin;
    s->st.bytes[s->pos + 1] ^= 0x04;
    s->st.bytes[STROBE_R + 1] ^= 0x80;
    keccak_f1600(s->st.lanes);
    s->pos = 0;
    s->pos_begin = 0;
}

static void absorb(strobe_t *s, const uint8_t *data, int64_t n) {
    while (n > 0) {
        int64_t k = STROBE_R - s->pos;
        if (k > n) k = n;
        uint8_t *st = s->st.bytes + s->pos;
        for (int64_t i = 0; i < k; i++) st[i] ^= data[i];
        s->pos += k;
        data += k;
        n -= k;
        if (s->pos == STROBE_R) run_f(s);
    }
}

static void overwrite(strobe_t *s, const uint8_t *data, int64_t n) {
    while (n > 0) {
        int64_t k = STROBE_R - s->pos;
        if (k > n) k = n;
        memcpy(s->st.bytes + s->pos, data, (size_t)k);
        s->pos += k;
        data += k;
        n -= k;
        if (s->pos == STROBE_R) run_f(s);
    }
}

static void squeeze(strobe_t *s, uint8_t *out, int64_t n) {
    while (n > 0) {
        int64_t k = STROBE_R - s->pos;
        if (k > n) k = n;
        memcpy(out, s->st.bytes + s->pos, (size_t)k);
        memset(s->st.bytes + s->pos, 0, (size_t)k);
        s->pos += k;
        out += k;
        n -= k;
        if (s->pos == STROBE_R) run_f(s);
    }
}

/* 0, or -1 when a continued op's flags differ, -2 for a transport op */
static int begin_op(strobe_t *s, int64_t flags, int more) {
    if (more) return flags == s->cur_flags ? 0 : -1;
    if (flags & FLAG_T) return -2;
    uint8_t hdr[2] = {(uint8_t)s->pos_begin, (uint8_t)flags};
    s->pos_begin = s->pos + 1;
    s->cur_flags = flags;
    absorb(s, hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) run_f(s);
    return 0;
}

int64_t strobe_state_size(void) { return (int64_t)sizeof(strobe_t); }

/* the state after STROBE's initial permutation, before the protocol label */
void strobe_init(strobe_t *s) {
    memset(s, 0, sizeof *s);
    const uint8_t head[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
    memcpy(s->st.bytes, head, 6);
    memcpy(s->st.bytes + 6, "STROBEv1.0.2", 12);
    keccak_f1600(s->st.lanes);
}

/* One operation: meta_ad / ad absorb `data`, key overwrites with it, prf
 * squeezes n bytes into it. */
int strobe_op(strobe_t *s, int64_t flags, int more, uint8_t *data, int64_t n) {
    int rc = begin_op(s, flags, more);
    if (rc) return rc;
    if (flags == (FLAG_I | FLAG_A | FLAG_C))
        squeeze(s, data, n);
    else if (flags == (FLAG_A | FLAG_C))
        overwrite(s, data, n);
    else
        absorb(s, data, n);
    return 0;
}

/* Merlin's append_message for `count` (label, message) pairs, label i at
 * labels[loff[i] : loff[i + 1]], message i at msgs[moff[i] : moff[i + 1]]. */
void merlin_append_messages(strobe_t *s, int64_t count, const uint8_t *labels,
                            const int64_t *loff, const uint8_t *msgs, const int64_t *moff) {
    for (int64_t i = 0; i < count; i++) {
        int64_t n = moff[i + 1] - moff[i];
        uint8_t len4[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16), (uint8_t)(n >> 24)};
        begin_op(s, FLAG_M | FLAG_A, 0);
        absorb(s, labels + loff[i], loff[i + 1] - loff[i]);
        absorb(s, len4, 4); /* meta_ad(len, more): the same op continued */
        begin_op(s, FLAG_A, 0);
        absorb(s, msgs + moff[i], n);
    }
}
