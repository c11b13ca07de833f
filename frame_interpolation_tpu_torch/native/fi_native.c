/* Host-side CRC32C and TFRecord framing for the port's data pipeline.
 *
 * A copy of frame_interpolation_tpu/native/_fi_native.c behind a plain C
 * interface (no Python headers), loaded with ctypes by native/__init__.py,
 * which builds it with `cc -O3 -shared -fPIC` at first use. ctypes
 * releases the interpreter lock around each call, so the dataset
 * builder's threads checksum in parallel.
 *
 *   fi_crc32c(buf, len)         slicing-by-8 CRC32C (Castagnoli)
 *   fi_masked_crc32c(buf, len)  the TFRecord-masked CRC32C
 *   fi_scan_tfrecord(buf, size, validate, offsets, lengths, capacity)
 *       walks the records of an in-memory TFRecord file; writes the
 *       payload offset and length of the first `capacity` of them and
 *       returns how many there are, or -1 if the data is truncated or
 *       (with `validate`) a CRC does not match.
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

static uint32_t crc_table[8][256];

__attribute__((constructor)) static void init_tables(void) {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++) crc = (crc >> 1) ^ (poly & (~(crc & 1) + 1));
    crc_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = crc_table[0][i];
    for (int t = 1; t < 8; t++) {
      crc = (crc >> 8) ^ crc_table[0][crc & 0xFF];
      crc_table[t][i] = crc;
    }
  }
}

uint32_t fi_crc32c(const uint8_t *buf, size_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  /* Slicing-by-8 over the bulk, a byte at a time over the tail. */
  while (len >= 8) {
    uint64_t word;
    memcpy(&word, buf, 8);
    word ^= (uint64_t)crc;
    crc = crc_table[7][word & 0xFF] ^ crc_table[6][(word >> 8) & 0xFF] ^
          crc_table[5][(word >> 16) & 0xFF] ^
          crc_table[4][(word >> 24) & 0xFF] ^
          crc_table[3][(word >> 32) & 0xFF] ^
          crc_table[2][(word >> 40) & 0xFF] ^
          crc_table[1][(word >> 48) & 0xFF] ^
          crc_table[0][(word >> 56) & 0xFF];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *buf++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

static uint32_t masked(uint32_t crc) {
  return (uint32_t)(((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

uint32_t fi_masked_crc32c(const uint8_t *buf, size_t len) {
  return masked(fi_crc32c(buf, len));
}

int64_t fi_scan_tfrecord(const uint8_t *buf, size_t size, int validate,
                         int64_t *offsets, int64_t *lengths,
                         int64_t capacity) {
  size_t pos = 0;
  int64_t count = 0;
  while (pos < size) {
    uint64_t length;
    uint32_t len_crc, data_crc;
    if (size - pos < 12) return -1;
    memcpy(&length, buf + pos, 8);
    memcpy(&len_crc, buf + pos + 8, 4);
    if (validate && masked(fi_crc32c(buf + pos, 8)) != len_crc) return -1;
    if (length > size - pos - 12 || size - pos - 12 - length < 4) return -1;
    memcpy(&data_crc, buf + pos + 12 + length, 4);
    if (validate && masked(fi_crc32c(buf + pos + 12, length)) != data_crc)
      return -1;
    if (count < capacity) {
      offsets[count] = (int64_t)(pos + 12);
      lengths[count] = (int64_t)length;
    }
    count++;
    pos += 12 + length + 4;
  }
  return count;
}
