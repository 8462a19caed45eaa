// High-dimensional Sobol sequence engine (native host runtime component).
//
// The Python sampler (ops/sampling.py) embeds the Joe-Kuo direction numbers
// for the first 21 dimensions; this C++ engine supports arbitrary dimensions
// by searching primitive polynomials over GF(2) on the fly and seeding the
// free initial direction numbers from a deterministic PRNG (standard
// construction; cf. Bratley & Fox ACM TOMS 659).  Exposed via ctypes — no
// pybind11 dependency.
//
// Build: g++ -O3 -shared -fPIC -o libsobol.so sobol.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NBITS = 32;

// --- GF(2) polynomial helpers (bit i = coefficient of x^i) -----------------

inline int degree(uint64_t p) {
    return 63 - __builtin_clzll(p);
}

// reduce a(x) mod m(x)
uint64_t polymod(uint64_t a, uint64_t m) {
    int dm = degree(m);
    while (a && degree(a) >= dm) a ^= m << (degree(a) - dm);
    return a;
}

// multiply a(x)*b(x) mod m(x) over GF(2); requires deg(a) < deg(m)
uint64_t polymulmod(uint64_t a, uint64_t b, uint64_t m) {
    uint64_t r = 0;
    int dm = degree(m);
    a = polymod(a, m);
    b = polymod(b, m);
    while (b) {
        if (b & 1) r ^= a;
        b >>= 1;
        a <<= 1;
        if ((a >> dm) & 1) a ^= m;
    }
    return r;
}

// x^e mod m(x)
uint64_t polypowmod(uint64_t e_base, uint64_t exp, uint64_t m) {
    uint64_t result = 1, base = e_base;
    while (exp) {
        if (exp & 1) result = polymulmod(result, base, m);
        base = polymulmod(base, base, m);
        exp >>= 1;
    }
    return result;
}

// irreducibility via Rabin's test for small degrees
bool is_irreducible(uint64_t p) {
    int n = degree(p);
    // x^(2^n) == x (mod p) and gcd condition on proper divisors
    uint64_t xq = 2;  // x
    for (int i = 0; i < n; ++i) xq = polymulmod(xq, xq, p);
    if (xq != 2) return false;
    // for each prime divisor d of n: x^(2^(n/d)) != x
    for (int d = 2; d <= n; ++d) {
        if (n % d) continue;
        bool prime = true;
        for (int k = 2; k * k <= d; ++k)
            if (d % k == 0) { prime = false; break; }
        if (!prime) continue;
        uint64_t xe = 2;
        for (int i = 0; i < n / d; ++i) xe = polymulmod(xe, xe, p);
        if (xe == 2) return false;
    }
    return true;
}

// multiplicative order of x mod p equals 2^deg - 1 (primitivity)
bool is_primitive(uint64_t p) {
    if (!is_irreducible(p)) return false;
    int n = degree(p);
    uint64_t group = (1ull << n) - 1;
    // factor `group` naively (n <= ~24 so group <= 16M)
    uint64_t g = group;
    std::vector<uint64_t> primes;
    for (uint64_t f = 2; f * f <= g; ++f) {
        if (g % f == 0) {
            primes.push_back(f);
            while (g % f == 0) g /= f;
        }
    }
    if (g > 1) primes.push_back(g);
    for (uint64_t q : primes) {
        if (polypowmod(2, group / q, p) == 1) return false;
    }
    return polypowmod(2, group, p) == 1;
}

// deterministic PRNG for free direction-number seeds (splitmix64)
inline uint64_t splitmix64(uint64_t& s) {
    s += 0x9E3779B97f4A7C15ull;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

struct DirectionTable {
    std::vector<uint32_t> v;  // dim * NBITS
    int dim = 0;

    void build(int want_dim) {
        if (want_dim <= dim) return;
        v.resize(size_t(want_dim) * NBITS);
        // dimension 0: van der Corput
        if (dim == 0) {
            for (int k = 0; k < NBITS; ++k)
                v[k] = 1u << (NBITS - 1 - k);
            dim = 1;
        }
        // enumerate primitive polynomials in increasing (degree, value) order
        // skipping those already consumed by dims < dim
        int produced = 1;  // dims produced so far (dim 0 done)
        uint64_t seed = 0x5EED5EED5EED5EEDull;
        for (int s = 1; produced < want_dim && s < 28; ++s) {
            for (uint64_t tail = 0; tail < (1ull << (s - 1)) &&
                                    produced < want_dim; ++tail) {
                // p = x^s + (tail bits)·x^{s-1..1} + 1
                uint64_t p = (1ull << s) | (tail << 1) | 1ull;
                if (!is_primitive(p)) continue;
                // a = interior coefficient bits (x^{s-1} .. x^1)
                uint64_t a = tail;
                uint32_t* vd = &v[size_t(produced) * NBITS];
                // free initial m_i: odd, < 2^i, deterministic
                std::vector<uint64_t> m(NBITS);
                for (int i = 0; i < s && i < NBITS; ++i) {
                    uint64_t r = splitmix64(seed);
                    m[i] = (r % (1ull << (i + 1))) | 1ull;  // odd, < 2^(i+1)
                }
                for (int k = 0; k < NBITS; ++k) {
                    if (k < s) {
                        vd[k] = uint32_t(m[k] << (NBITS - 1 - k));
                    } else {
                        uint64_t val = vd[k - s] ^ (uint64_t(vd[k - s]) >> s);
                        for (int i = 1; i < s; ++i) {
                            if ((a >> (s - 1 - i)) & 1) val ^= vd[k - i];
                        }
                        vd[k] = uint32_t(val);
                    }
                }
                if (produced >= dim) {
                    // newly built dim — nothing else to do
                }
                ++produced;
            }
        }
        dim = produced;
    }
};

DirectionTable g_table;

}  // namespace

extern "C" {

// Fill `out` (dim * npoints, row-major per dimension) with the Sobol bit
// patterns of points [skip, skip + npoints).  Returns 0 on success.
int sobol_points(uint32_t npoints, uint32_t dim, uint32_t skip, uint32_t* out) {
    if (dim == 0 || npoints == 0) return 1;
    g_table.build(int(dim));
    if (g_table.dim < int(dim)) return 2;
    std::vector<uint32_t> x(dim, 0);
    // advance to index `skip` using the Gray-code identity
    // x_n = XOR over set bits of gray(n) of v[ctz positions]; compute directly
    uint32_t n0 = skip;
    uint32_t gray = n0 ^ (n0 >> 1);
    for (uint32_t d = 0; d < dim; ++d) {
        const uint32_t* vd = &g_table.v[size_t(d) * NBITS];
        uint32_t acc = 0;
        for (int b = 0; b < NBITS; ++b)
            if ((gray >> b) & 1) acc ^= vd[b];
        x[d] = acc;
    }
    for (uint32_t i = 0; i < npoints; ++i) {
        for (uint32_t d = 0; d < dim; ++d)
            out[size_t(d) * npoints + i] = x[d];
        uint32_t n = skip + i + 1;
        int c = __builtin_ctz(n);  // bit that flips in the Gray code
        if (c < NBITS) {
            for (uint32_t d = 0; d < dim; ++d)
                x[d] ^= g_table.v[size_t(d) * NBITS + c];
        }
    }
    return 0;
}

// Maximum dimension the engine will build (bounded by polynomial search).
int sobol_max_dim() { return 1 << 20; }

}  // extern "C"
